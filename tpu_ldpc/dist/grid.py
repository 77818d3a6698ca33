"""Grid-sharded Monte-Carlo: SNR points x codeword batches over the mesh
(SURVEY.md §2.2 "EP" row; BASELINE.json config 5's full shape).

The plain DP path (dist.mesh) puts every device on the same Eb/N0 point.
Near the end of a sweep that wastes chips: low-FER points need millions
of frames while high-FER points finished long ago.  Here each device is
a *slot* that the host scheduler assigns an (snr_idx, batch_ctr) cell
per dispatch — heterogeneous sweep parallelism, the expert-parallel
analog for this workload.

PRNG discipline: grid mode folds (seed, snr_idx, ctr, device=0) — the
same stream family as a single-device run — and the scheduler hands out
strictly increasing ctrs per point, so a grid-sharded sweep's counters
for each point are EXACTLY a single-device run's (asserted in tests):
scheduling changes who computes a batch, never which batches exist.
"""

from __future__ import annotations

import functools
import time
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from jax import shard_map

from tpu_ldpc.channel.awgn import awgn_llrs
from tpu_ldpc.codes.code import LdpcCode
from tpu_ldpc.dist.mesh import fold_key_device


@functools.lru_cache(maxsize=64)
def build_grid_mc_step(
    code: LdpcCode,
    cfg,
    batch: int,
    mesh: Mesh,
    axis: str = "mc",
):
    """Jitted SPMD step: per-device (seed, snr_idx, ebn0, ctr) cells ->
    per-device counter rows (D, 6).  No collective: rows return sharded
    and the host accumulates them into their points."""
    from tpu_ldpc.decode.api import build_decode_fn
    from tpu_ldpc.encode.encoder import build_encoder

    encode_fn = build_encoder(code, "generator")
    decode_fn = build_decode_fn(code, cfg)
    k, rate = code.k, code.rate

    def local(seed, snr_idx, ebn0_db, ctr):
        # device index 0 on purpose: see module docstring
        key = fold_key_device(seed[0], snr_idx[0], ctr[0], 0)
        key_u, key_n = jax.random.split(key)
        u = jax.random.bernoulli(key_u, 0.5, (batch, k)).astype(jnp.uint8)
        c = encode_fn(u)
        llr = awgn_llrs(key_n, c, ebn0_db[0], rate)
        bits, ok, iters_used = decode_fn(llr)
        wrong = bits[:, :k] != u
        frame_wrong = jnp.any(wrong, axis=1)
        return jnp.stack(
            [
                jnp.asarray(batch, jnp.int32),
                jnp.sum(wrong, dtype=jnp.int32),
                jnp.sum(frame_wrong, dtype=jnp.int32),
                jnp.sum(~ok, dtype=jnp.int32),
                jnp.sum(ok & frame_wrong, dtype=jnp.int32),
                jnp.sum(iters_used, dtype=jnp.int32),
            ]
        )[None, :]

    sharded = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P(axis)),
        out_specs=P(axis),
        check_vma=False,
    )
    return jax.jit(sharded)


def run_ber_grid(
    code: LdpcCode,
    ebn0_grid: Sequence[float],
    cfg,
    batch: int = 256,
    target_frame_errors: int = 100,
    max_frames: int = 1_000_000,
    seed: int = 0,
    mesh: Mesh = None,
    axis: str = "mc",
    progress: bool = False,
):
    """Frame-error-targeted sweep with SNR x batch cells sharded."""
    from tpu_ldpc.sim.mc import SnrResult

    n_dev = mesh.shape[axis]
    step = build_grid_mc_step(code, cfg, batch, mesh, axis)
    results = [SnrResult(ebn0_db=float(e)) for e in ebn0_grid]
    next_ctr = [0] * len(ebn0_grid)
    t0 = time.perf_counter()

    def unfinished():
        return [
            i for i, r in enumerate(results)
            if r.frame_errors < target_frame_errors and r.frames < max_frames
        ]

    rr = 0
    while True:
        active = unfinished()
        if not active:
            break
        # round-robin assignment of active points to device slots
        assignment = []
        for s in range(n_dev):
            p = active[(rr + s) % len(active)]
            assignment.append((p, next_ctr[p]))
            next_ctr[p] += 1
        rr += n_dev
        snr_idx = jnp.asarray([a[0] for a in assignment], jnp.int32)
        ebn0 = jnp.asarray(
            [ebn0_grid[a[0]] for a in assignment], jnp.float32
        )
        ctrs = jnp.asarray([a[1] for a in assignment], jnp.int32)
        rows = np.asarray(jax.device_get(step(
            jnp.asarray([seed], jnp.int32), snr_idx, ebn0, ctrs
        )))
        for (p, _), row in zip(assignment, rows):
            r = results[p]
            r.frames += int(row[0])
            r.bit_errors += int(row[1])
            r.frame_errors += int(row[2])
            r.detected += int(row[3])
            r.undetected += int(row[4])
            r.iter_sum += int(row[5])
    wall = time.perf_counter() - t0
    for r in results:
        r.bits = r.frames * code.k
        r.wall_s = wall / len(results)
        if progress:
            print(
                f"Eb/N0 {r.ebn0_db:5.2f} dB [grid x{n_dev}]: "
                f"frames={r.frames} FER={r.fer:.3e} BER={r.ber:.3e}"
            )
    return results
