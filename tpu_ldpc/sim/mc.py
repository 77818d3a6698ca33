"""Monte-Carlo BER/FER harness (SURVEY.md C10/C11, call stack §3.1).

Structure: a jitted per-device MC step (PRNG -> encode -> BPSK/AWGN ->
decode -> counter reduction) driven by a host control loop with
frame-error-targeted stopping per Eb/N0 point.  Host<->device traffic
per step is O(counters).

PRNG discipline (C11): every batch's key is folded from
(base_seed, snr_index, batch_counter [, device index when sharded]), so
resumed, re-batched, or multi-device runs draw from the same per-cell
streams instead of reshuffling one global stream.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from tpu_ldpc import backend
from tpu_ldpc.channel.awgn import awgn_llrs
from tpu_ldpc.codes.code import LdpcCode
from tpu_ldpc.encode.encoder import build_encoder


@dataclasses.dataclass(frozen=True)
class DecodeCfg:
    algo: str = "minsum"
    iters: int = 50
    alpha: float = 0.75
    beta: float = 0.0
    schedule: str = "flooding"  # 'flooding' | 'layered' | 'windowed'
    impl: str = "auto"  # 'auto' | 'jnp' | 'pallas' | 'twophase'
    # schedule='windowed' only (SC-LDPC chains, decode/windowed.py):
    # window width in block-rows; cfg.iters then counts iterations PER
    # WINDOW SLIDE, not total.  window_sweep picks the within-window
    # schedule ('flooding' | 'layered' — the layered sweep rides the
    # slide direction and needs fewer iters/position, r5)
    window: int = 8
    window_sweep: str = "flooding"
    # fixed-point hardware-emulation mode (min-sum only; golden contract
    # in tpu_ldpc/golden/decoder.py): message bits / LSB step / APP bits
    quant_bits: int | None = None
    quant_step: float = 0.5
    quant_post_bits: int | None = None
    # impl='twophase' only (decode/twophase.py): phase-1 iteration
    # budget K and the compacted phase-2 batch size.  None (default)
    # resolves per-cell tuned values from the registry metadata
    # (codes/data/twophase_knobs.json, from measured iteration
    # distributions) with a rate-derived fallback — see decode/knobs.py.  Explicit values
    # always win; a too-small budget costs ~2x via the full-batch
    # fallback (DESIGN.md §3.5), which is warned about when the knobs
    # were resolved rather than explicit.
    phase1_iters: int | None = None
    compact_budget: int | None = None


COUNTER_FIELDS = (
    "frames",
    "bit_errors",      # over info bits (payload bits when CRC-gated)
    "frame_errors",    # any info bit wrong
    "detected",        # decoder reported not-ok (syndrome unsatisfied);
    #                    CRC-gated runs: outer CRC FAILED
    "undetected",      # syndrome ok but wrong codeword; CRC-gated
    #                    runs: CRC PASSED on a wrong payload (false ACK)
    "iter_sum",        # sum of iters_used
)


@dataclasses.dataclass
class SnrResult:
    ebn0_db: float
    frames: int = 0
    bit_errors: int = 0
    frame_errors: int = 0
    detected: int = 0
    undetected: int = 0
    iter_sum: int = 0
    wall_s: float = 0.0

    @property
    def fer(self) -> float:
        return self.frame_errors / max(self.frames, 1)

    @property
    def ber(self) -> float:
        # info-bit error rate; k filled in by the harness via bits_per_frame
        return self.bit_errors / max(self.bits, 1)

    bits: int = 0

    @property
    def mean_iters(self) -> float:
        return self.iter_sum / max(self.frames, 1)


def _log_step(path: str, code, res, t0: float, k: int | None = None) -> None:
    import json

    elapsed = time.perf_counter() - t0
    rec = {
        "ebn0_db": res.ebn0_db,
        "frames": res.frames,
        "bit_errors": res.bit_errors,
        "frame_errors": res.frame_errors,
        "mean_iters": res.mean_iters,
        "wall_s": round(elapsed, 4),
        "info_bits_per_s": round(res.frames * (k or code.k) / max(elapsed, 1e-9), 1),
    }
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")


def fold_key(base_seed: int, snr_idx: int, batch_ctr: int) -> jax.Array:
    key = jax.random.key(base_seed)
    key = jax.random.fold_in(key, snr_idx)
    return jax.random.fold_in(key, batch_ctr)


# test-only fault-injection hook (SURVEY.md §5): called as
# hook(key, bits, ok, iters_used) -> (bits, ok, iters_used) inside the
# jitted step, letting tests corrupt decoder outputs (bit flips, dropped
# contributions) and assert the counter accounting detects it.  Captured
# at trace time: call build_mc_step.cache_clear() after changing it.
_FAULT_HOOK = None


def build_batch_fn(code: LdpcCode, cfg: DecodeCfg, batch: int,
                   adapt=None, fault_hook=None, crc=None):
    """Shared per-batch MC kernel: (key, ebn0_db) -> (6,) int32 counters.

    Used by both the single-device (build_mc_step) and sharded
    (dist.mesh.build_sharded_mc_step) step builders.  Handles rate
    adaptation (channel.adapt.RateAdapt): shortened info bits are drawn
    as zeros and excluded from error counting, the channel erases
    punctured positions and saturates shortened ones, and Eb/N0 is
    referenced to the effective rate k_eff/n_tx.  `.k` on the returned
    function is the effective info bits counted per frame.

    crc (codes/crc.py name or CrcSpec, VERDICT r4 #1): when set, the
    info block is [payload | crc(payload)] (payload random, CRC
    deterministic — both attached and checked via one matmul each
    inside the jitted step) and the detected/undetected counters are
    CRC-GATED: detected = outer CRC failed, undetected = CRC passed on
    a wrong payload (false ACK).  frame/bit errors stay genie-counted
    over the PAYLOAD bits, and `.k` (bits credited per frame) excludes
    the CRC overhead.  Incompatible with shortening (the CRC would
    span frozen bits); puncturing composes fine.
    """
    from tpu_ldpc.decode.api import build_decode_fn
    from tpu_ldpc.encode.encoder import select_encoder

    encode_fn, k, info_cols = select_encoder(code)
    decode_fn = build_decode_fn(code, cfg)
    if crc is not None:
        from tpu_ldpc.codes.crc import (
            get_spec, make_crc_attacher, make_crc_checker)

        spec = get_spec(crc)
        kp = k - spec.width
        if kp <= 0:
            raise ValueError(
                f"{spec.name} width {spec.width} >= info length {k}")
        if adapt is not None and not adapt.masks(
                code.n, k, info_cols)[2].all():
            raise ValueError("crc + shortening unsupported: the CRC "
                             "would span frozen info bits")
        crc_attach = make_crc_attacher(kp, spec)
        crc_ok_fn = make_crc_checker(k, spec)
    else:
        kp = k
    if adapt is not None:
        from tpu_ldpc.channel.adapt import adapted_awgn_llrs

        k_eff, n_tx = adapt.dims(code.n, k)
        # Eb/N0 references energy actually transmitted per effective bit
        tx_np, known_np, active_np = adapt.masks(code.n, k, info_cols)
        tx_mask, known_llr = jnp.asarray(tx_np), jnp.asarray(known_np)
        active_u = jnp.asarray(active_np)
    else:
        # true information rate (k may exceed the design dimension for
        # rank-deficient codes, e.g. terminated SC chains)
        k_eff, n_tx = k, code.n
    if crc is not None:
        k_eff -= spec.width  # CRC bits are overhead, not information
    rate = k_eff / n_tx
    info_cols_j = None if info_cols is None else jnp.asarray(info_cols)

    def one_batch(key, ebn0_db):
        key_u, key_n = jax.random.split(key)
        if crc is not None:
            payload = jax.random.bernoulli(
                key_u, 0.5, (batch, kp)).astype(jnp.uint8)
            u = crc_attach(payload)
        else:
            u = jax.random.bernoulli(
                key_u, 0.5, (batch, k)).astype(jnp.uint8)
        if adapt is not None:
            u = u * active_u
        c = encode_fn(u)
        if adapt is not None:
            llr = adapted_awgn_llrs(key_n, c, ebn0_db, rate, tx_mask, known_llr)
        else:
            llr = awgn_llrs(key_n, c, ebn0_db, rate)
        bits, ok, iters_used = decode_fn(llr)
        if fault_hook is not None:
            bits, ok, iters_used = fault_hook(key, bits, ok, iters_used)
        info = bits[:, :k] if info_cols_j is None else bits[:, info_cols_j]
        wrong = info != u
        if adapt is not None:
            wrong = wrong & (active_u == 1)
        if crc is not None:
            wrong = wrong[:, :kp]  # genie errors over PAYLOAD bits
            passed = crc_ok_fn(info)
        frame_wrong = jnp.any(wrong, axis=1)
        det = ~passed if crc is not None else ~ok
        undet = (passed if crc is not None else ok) & frame_wrong
        return jnp.stack(
            [
                jnp.asarray(batch, jnp.int32),
                jnp.sum(wrong, dtype=jnp.int32),
                jnp.sum(frame_wrong, dtype=jnp.int32),
                jnp.sum(det, dtype=jnp.int32),
                jnp.sum(undet, dtype=jnp.int32),
                jnp.sum(iters_used, dtype=jnp.int32),
            ]
        )

    one_batch.k = k_eff
    return one_batch


@functools.lru_cache(maxsize=64)
def build_mc_step(
    code: LdpcCode,
    cfg: DecodeCfg,
    batch: int,
    steps_per_call: int = 1,
    adapt=None,
    crc=None,
):
    """Jitted MC step: (seed, snr_idx, ebn0_db, ctr0) -> counter vector.

    Eb/N0 is a *traced* scalar, so one compilation serves the entire
    sweep; `steps_per_call` batches run per dispatch inside an on-device
    fori_loop, so the host reads counters once per dispatch.  PRNG
    discipline is unchanged: inner step t uses
    fold_key(seed, snr_idx, ctr0 + t), so counter totals are identical
    for any steps_per_call grouping.
    """
    one_batch = build_batch_fn(code, cfg, batch, adapt,
                               fault_hook=_FAULT_HOOK, crc=crc)

    @jax.jit
    def step(seed, snr_idx, ebn0_db, ctr0):
        def body(t, acc):
            key = fold_key(seed, snr_idx, ctr0 + t)
            return acc + one_batch(key, ebn0_db)

        return jax.lax.fori_loop(
            0, steps_per_call, body, jnp.zeros(6, jnp.int32)
        )

    def stepper(*args):
        return step(*args)

    stepper.k = one_batch.k  # effective info bits per frame
    return stepper


def run_ber(
    code: LdpcCode,
    ebn0_grid: Sequence[float],
    cfg: DecodeCfg = DecodeCfg(),
    batch: int = 256,
    target_frame_errors: int = 100,
    max_frames: int = 1_000_000,
    seed: int = 0,
    mesh=None,
    progress: bool = False,
    state=None,
    steps_per_call: int | None = None,
    step_log: str | None = None,
    adapt=None,
    crc=None,
) -> list[SnrResult]:
    """Frame-error-targeted Eb/N0 sweep.  Single-device unless `mesh`
    is given (then the batch is sharded; see tpu_ldpc.dist).

    step_log: path for per-dispatch JSONL observability records
    (SURVEY.md §5: snr, cumulative frames/errors, mean iters, wall
    time, decoded info bits/s).
    adapt: optional channel.adapt.RateAdapt puncturing/shortening spec.
    crc: optional outer CRC (codes/crc.py name or CrcSpec) — attaches
    CRC bits to the info block and gates the detected/undetected
    counters on it (see build_batch_fn).
    """
    if mesh is not None:
        from tpu_ldpc.dist.mesh import run_ber_sharded

        return run_ber_sharded(
            code, ebn0_grid, cfg, batch, target_frame_errors, max_frames,
            seed, mesh, progress=progress, state=state,
            steps_per_call=steps_per_call, step_log=step_log, adapt=adapt,
            crc=crc,
        )
    if steps_per_call is None:
        steps_per_call = backend.steps_per_call()
    step = build_mc_step(code, cfg, batch, steps_per_call, adapt, crc)
    results = []
    for snr_idx, ebn0 in enumerate(ebn0_grid):
        res = SnrResult(ebn0_db=float(ebn0))
        batch_ctr = 0
        if state is not None:
            saved = state.load_point(snr_idx)
            if saved is not None:
                res, batch_ctr = saved
        t0 = time.perf_counter()
        while res.frame_errors < target_frame_errors and res.frames < max_frames:
            counters = np.asarray(jax.device_get(step(
                jnp.asarray(seed, jnp.int32),
                jnp.asarray(snr_idx, jnp.int32),
                jnp.asarray(ebn0, jnp.float32),
                jnp.asarray(batch_ctr, jnp.int32),
            )))
            res.frames += int(counters[0])
            res.bit_errors += int(counters[1])
            res.frame_errors += int(counters[2])
            res.detected += int(counters[3])
            res.undetected += int(counters[4])
            res.iter_sum += int(counters[5])
            batch_ctr += steps_per_call
            if state is not None:
                state.save_point(snr_idx, res, batch_ctr)
            if step_log is not None:
                _log_step(step_log, code, res, t0, getattr(step, 'k', None))
        res.wall_s += time.perf_counter() - t0
        res.bits = res.frames * getattr(step, "k", code.k)
        results.append(res)
        if progress:
            print(
                f"Eb/N0 {ebn0:5.2f} dB: frames={res.frames} "
                f"FER={res.fer:.3e} BER={res.ber:.3e} "
                f"mean_iters={res.mean_iters:.1f}"
            )
    return results
