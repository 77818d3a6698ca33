"""Shared on-device throughput estimator (SURVEY.md C13, call stack §3.5).

Used by the driver-facing `bench.py` and `cli/bench.py` so the judge
metric's producer has exactly one implementation (and one test surface).

Method:

  * N decode calls run inside ONE device computation (`lax.fori_loop`),
    minus a matched generation-only loop, so host dispatch and
    round-trip costs stay out of the per-decode time.
  * Input freshness: a noise tensor is generated on-device once per
    dispatch from the dispatch key; each inner step decodes
    x + noise0 * a_i with a per-step scalar a_i near 1.  No large
    buffer recurs across dispatches, and every inner step's input
    content differs.  Per-step cost is one elementwise pass instead of
    a full threefry normal generation, whose cost would otherwise
    dominate the subtraction error.
  * Decode and generation loops are timed interleaved, per-rep paired
    deltas taken, and the MEDIAN delta reported (robust to host
    hiccups); the best delta is reported alongside.
"""

from __future__ import annotations

import time

import numpy as np


class LoopTimer:
    """Times decode functions against a shared generation-only baseline.

    x: (batch, n) BPSK symbols (+-1) for the frames being decoded;
    scale/sig: LLR scale 2/sigma^2 and noise sigma for the operating
    point.  `inner` steps run per dispatch.
    """

    def __init__(self, x, scale: float, sig: float, inner: int = 20,
                 mask=None):
        import jax
        import jax.numpy as jnp

        self._jax = jax
        self.xj = jnp.asarray(np.asarray(x), jnp.float32)
        self.scale = float(scale)
        self.sig = float(sig)
        self.inner = int(inner)
        # optional (n,) 0/1 channel mask (punctured positions enter the
        # decoder as erasures — the NR operating condition); applied in
        # BOTH loops so the subtraction stays symmetric
        self.maskj = (None if mask is None
                      else jnp.asarray(np.asarray(mask), jnp.float32))
        self._gen_loop = self._make_loop(None)
        # traced-op-point loops (measure_at): keyed BY THE DECODER
        # OBJECT (the dict entry keeps it alive — never key a cache by
        # bare id(), CLAUDE.md bug class)
        self._traced = {}

    def _make_loop(self, dec):
        jax = self._jax
        import jax.numpy as jnp

        xj, scale, sig, inner = self.xj, self.scale, self.sig, self.inner

        @jax.jit
        def many(key0):
            noise0 = sig * jax.random.normal(key0, xj.shape, jnp.float32)

            def body(i, acc):
                # fresh content per step at one multiply pass: the whole
                # received signal (x + noise) scaled by a per-step factor
                # near 1.  Scaling LLRs uniformly leaves min-sum decode
                # trajectories EXACTLY invariant (sign/min/compare are
                # scale-homogeneous), so early-termination statistics
                # stay bit-realistic for the operating point while the
                # input buffer content differs every step (cache-bust).
                # LANDMINE: scaling the NOISE only lowers the effective
                # SNR by up to 0.17 dB — min-sum stragglers after
                # twophase phase 1 then overflow the compaction budget
                # and every step pays the full-batch fallback.
                a_i = 1.0 + i.astype(jnp.float32) * (0.02 / inner)
                llr = (scale * a_i) * (xj + noise0)
                if self.maskj is not None:
                    llr = llr * self.maskj
                if dec is None:
                    # full-tensor reduction so generation can't be DCE'd;
                    # identical term exists in neither loop's decode path,
                    # but is part of the subtracted baseline by symmetry
                    # with round 1's estimator
                    return acc + jnp.sum(llr).astype(jnp.int32)
                bits, ok, iu = dec(llr)
                # consume EVERY output: with early_stop=False, iu alone
                # is data-independent and XLA dead-code-eliminates the
                # whole jnp reference decode (measured: negative deltas
                # on CPU).  The extra reductions are O(batch*n) int adds,
                # noise next to 50 BP iterations.
                return (acc + jnp.sum(iu)
                        + jnp.sum(ok.astype(jnp.int32))
                        + jnp.sum(bits.astype(jnp.int32)))

            return jax.lax.fori_loop(0, inner, body, jnp.int32(0))

        return many

    def _make_traced_loop(self, dec):
        """Like _make_loop but (scale, sig) are TRACED scalars: one
        compile serves every operating point — required for HARQ
        per-stage sweeps (a closure-constant loop would recompile per
        Eb/N0).  The judged bench path (measure) is untouched."""
        jax = self._jax
        import jax.numpy as jnp

        xj, inner, maskj = self.xj, self.inner, self.maskj

        @jax.jit
        def many(key0, scale, sig):
            noise0 = sig * jax.random.normal(key0, xj.shape, jnp.float32)

            def body(i, acc):
                a_i = 1.0 + i.astype(jnp.float32) * (0.02 / inner)
                llr = (scale * a_i) * (xj + noise0)
                if maskj is not None:
                    llr = llr * maskj
                if dec is None:
                    return acc + jnp.sum(llr).astype(jnp.int32)
                bits, ok, iu = dec(llr)
                return (acc + jnp.sum(iu)
                        + jnp.sum(ok.astype(jnp.int32))
                        + jnp.sum(bits.astype(jnp.int32)))

            return jax.lax.fori_loop(0, inner, body, jnp.int32(0))

        return many

    def measure_at(self, dec, scale: float, sig: float,
                   reps: int = 5) -> dict:
        """measure() at an explicit (scale, sig) operating point using
        the traced loops; per-(dec) compile happens once, later points
        re-dispatch the same executable."""
        jax = self._jax
        import jax.numpy as jnp

        sc = jnp.asarray(scale, jnp.float32)
        sg = jnp.asarray(sig, jnp.float32)
        for k in (None, dec):
            if k not in self._traced:
                self._traced[k] = self._make_traced_loop(k)
        loop, gen = self._traced[dec], self._traced[None]
        jax.block_until_ready(loop(jax.random.key(999), sc, sg))
        jax.block_until_ready(gen(jax.random.key(998), sc, sg))
        dec_s, gen_s = [], []
        for r in range(int(reps)):
            t0 = time.perf_counter()
            jax.block_until_ready(loop(jax.random.key(2 * r), sc, sg))
            dec_s.append((time.perf_counter() - t0) / self.inner)
            t0 = time.perf_counter()
            jax.block_until_ready(gen(jax.random.key(2 * r + 1), sc, sg))
            gen_s.append((time.perf_counter() - t0) / self.inner)
        deltas = [d - g for d, g in zip(dec_s, gen_s)]
        return {
            "median_s": float(np.median(deltas)),
            "best_s": float(min(deltas)),
            "dec_ms": [round(d * 1e3, 4) for d in dec_s],
            "gen_ms": [round(g * 1e3, 4) for g in gen_s],
        }

    def measure(self, dec, reps: int = 7) -> dict:
        """Time `dec` (llr -> (bits, ok, iters_used)); returns per-batch
        seconds: median/best of per-rep paired (decode - generation)
        deltas, plus the raw per-rep times for the record."""
        jax = self._jax
        loop = self._make_loop(dec)
        # compile + first-dispatch warmup for both loops
        jax.block_until_ready(loop(jax.random.key(999)))
        jax.block_until_ready(self._gen_loop(jax.random.key(998)))
        dec_s, gen_s = [], []
        for r in range(int(reps)):
            t0 = time.perf_counter()
            jax.block_until_ready(loop(jax.random.key(2 * r)))
            dec_s.append((time.perf_counter() - t0) / self.inner)
            t0 = time.perf_counter()
            jax.block_until_ready(self._gen_loop(jax.random.key(2 * r + 1)))
            gen_s.append((time.perf_counter() - t0) / self.inner)
        deltas = [d - g for d, g in zip(dec_s, gen_s)]
        return {
            "median_s": float(np.median(deltas)),
            "best_s": float(min(deltas)),
            "dec_ms": [round(d * 1e3, 4) for d in dec_s],
            "gen_ms": [round(g * 1e3, 4) for g in gen_s],
        }


def make_timer(code, batch: int, ebn0_db: float = 2.0, inner: int = 20,
               seed: int = 0, n_punct: int = 0,
               rate: float | None = None):
    """LoopTimer over `batch` random encoded frames of `code` at the
    given operating point; also returns the info bits u for FER checks.

    n_punct: leading never-transmitted positions (erasure LLRs — the
    NR operating condition); Eb/N0 then references k/(n - n_punct)
    unless `rate` overrides it (HARQ stages reference the FIRST
    transmission's payload rate, whatever truncation is decoded)."""
    from tpu_ldpc.channel import noise_sigma2
    from tpu_ldpc.golden import encode as golden_encode

    rng = np.random.default_rng(seed)
    if rate is None:
        rate = (code.k / (code.n - n_punct)) if n_punct else code.rate
    sigma2 = noise_sigma2(ebn0_db, rate)
    u = rng.integers(0, 2, (batch, code.k)).astype(np.uint8)
    c = golden_encode(code.H, u)
    x = (1.0 - 2.0 * c).astype(np.float32)
    mask = None
    if n_punct:
        mask = np.ones(code.n, np.float32)
        mask[:n_punct] = 0.0
    timer = LoopTimer(x, scale=2.0 / sigma2, sig=float(np.sqrt(sigma2)),
                      inner=inner, mask=mask)
    return timer, u
