"""Distributed Monte-Carlo backend (SURVEY.md C12, call stack §3.3).

The JAX-native equivalent of the reference's (absent) NCCL/MPI layer:
`jax.distributed.initialize` for multi-host rendezvous, a 1-D device
mesh `('mc',)` over all chips, `shard_map` for SPMD placement, and a
single `psum` reducing the six error counters over ICI/DCN.  No
user-level transport code — correctness lives in mesh construction,
per-device key folding, and replicated-control early stopping.

PRNG discipline (C11): each device folds (base_seed, snr_idx,
batch_ctr, device_index), so an N-device run draws a superset of the
streams a 1-device run draws — counter totals are reproducible for any
mesh shape, and tests assert an 8-device run equals the sum of the
corresponding single-device streams.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from jax import shard_map

from tpu_ldpc.codes.code import LdpcCode


def init_distributed(**kw):
    """Multi-host rendezvous (no-op on a single process)."""
    try:
        jax.distributed.initialize(**kw)
    except (ValueError, RuntimeError):
        pass  # already initialized or single-process


def make_mesh(devices=None, axis: str = "mc") -> Mesh:
    """1-D Monte-Carlo mesh over all (or the given) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.array(devices), (axis,))


def fold_key_device(base_seed, snr_idx, batch_ctr, device_idx):
    """Per-device PRNG stream (traced-friendly)."""
    key = jax.random.key(base_seed)
    key = jax.random.fold_in(key, snr_idx)
    key = jax.random.fold_in(key, batch_ctr)
    return jax.random.fold_in(key, device_idx)


@functools.lru_cache(maxsize=64)
def build_sharded_mc_step(
    code: LdpcCode,
    cfg,
    per_device_batch: int,
    mesh: Mesh,
    axis: str = "mc",
    steps_per_call: int = 1,
    adapt=None,
    crc=None,
):
    """Jitted SPMD MC step:
    (seed, snr_idx, ebn0_db, ctr0) -> psum'd counters.

    Eb/N0 is traced (one compile per sweep); `steps_per_call` batches
    run per dispatch on every device.  The returned counters are
    replicated over the mesh, so every host's control loop sees
    identical values and makes identical early-stop decisions (§3.3's
    replicated-control discipline).  The per-batch kernel (encode ->
    channel [incl. rate adaptation] -> decode -> count) is shared with
    the single-device path (sim.mc.build_batch_fn).
    """
    from tpu_ldpc.sim.mc import build_batch_fn

    one_batch = build_batch_fn(code, cfg, per_device_batch, adapt,
                               crc=crc)

    def local_step(seed, snr_idx, ebn0_db, ctr0):
        dev = jax.lax.axis_index(axis)

        def body(t, acc):
            key = fold_key_device(seed[0], snr_idx[0], ctr0[0] + t, dev)
            return acc + one_batch(key, ebn0_db[0])

        counters = jax.lax.fori_loop(
            0, steps_per_call, body, jnp.zeros(6, jnp.int32)
        )
        return jax.lax.psum(counters, axis)  # ★ the collective (ICI/DCN)

    sharded = jax.jit(shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(), P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    ))

    def stepper(*args):
        return sharded(*args)

    stepper.k = one_batch.k  # effective info bits per frame
    return stepper


def run_ber_sharded(
    code: LdpcCode,
    ebn0_grid: Sequence[float],
    cfg,
    batch: int,
    target_frame_errors: int,
    max_frames: int,
    seed: int,
    mesh: Mesh,
    axis: str = "mc",
    progress: bool = False,
    state=None,
    steps_per_call: int | None = None,
    step_log: str | None = None,
    adapt=None,
    crc=None,
):
    """Multi-device frame-error-targeted sweep (host loop of §3.3).

    `batch` is the per-device batch; each dispatch decodes
    batch * mesh.size * steps_per_call frames across the mesh.
    """
    from tpu_ldpc import backend
    from tpu_ldpc.sim.mc import SnrResult

    if steps_per_call is None:
        steps_per_call = backend.steps_per_call()
    n_dev = mesh.size
    step = build_sharded_mc_step(
        code, cfg, batch, mesh, axis, steps_per_call, adapt, crc
    )
    results = []
    for snr_idx, ebn0 in enumerate(ebn0_grid):
        res = SnrResult(ebn0_db=float(ebn0))
        batch_ctr = 0
        if state is not None:
            saved = state.load_point(snr_idx)
            if saved is not None:
                res, batch_ctr = saved
        t0 = time.perf_counter()
        while (
            res.frame_errors < target_frame_errors and res.frames < max_frames
        ):
            counters = np.asarray(jax.device_get(step(
                jnp.asarray([seed], jnp.int32),
                jnp.asarray([snr_idx], jnp.int32),
                jnp.asarray([ebn0], jnp.float32),
                jnp.asarray([batch_ctr], jnp.int32),
            )))
            # counters are already psum'd (replicated): every host adds the
            # same totals, so stop decisions agree across processes
            res.frames += int(counters[0])
            res.bit_errors += int(counters[1])
            res.frame_errors += int(counters[2])
            res.detected += int(counters[3])
            res.undetected += int(counters[4])
            res.iter_sum += int(counters[5])
            batch_ctr += steps_per_call
            if state is not None:
                state.save_point(snr_idx, res, batch_ctr)
            if step_log is not None and jax.process_index() == 0:
                from tpu_ldpc.sim.mc import _log_step

                _log_step(step_log, code, res, t0, getattr(step, 'k', None))
        res.wall_s += time.perf_counter() - t0
        res.bits = res.frames * getattr(step, "k", code.k)
        results.append(res)
        if progress and jax.process_index() == 0:
            print(
                f"Eb/N0 {ebn0:5.2f} dB [{n_dev} dev]: frames={res.frames} "
                f"FER={res.fer:.3e} BER={res.ber:.3e} "
                f"mean_iters={res.mean_iters:.1f}"
            )
    return results
