"""sumproduct-fast (lambda-min2 PWL SP approximation) and the two-phase
straggler-compaction ET decoder (SURVEY.md C6/C9; VERDICT r1 next-#2).
"""

import numpy as np
import pytest

from tpu_ldpc.channel import noise_sigma2
from tpu_ldpc.codes import LdpcCode, make_base_graph
from tpu_ldpc.decode.pallas_bp import build_pallas_decoder
from tpu_ldpc.decode.reference import build_decoder
from tpu_ldpc.decode.twophase import build_twophase_decoder
from tpu_ldpc.golden import decode as golden_decode
from tpu_ldpc.golden import encode as golden_encode


@pytest.fixture(scope="module")
def small_code():
    return LdpcCode.from_base_graph(make_base_graph(4, 8, 8, seed=3), 8)


def _noisy_llrs(code, batch, ebn0_db, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (batch, code.k)).astype(np.uint8)
    c = golden_encode(code.H, u)
    s2 = noise_sigma2(ebn0_db, code.rate)
    llr = ((2 / s2) * ((1.0 - 2.0 * c)
                       + np.sqrt(s2) * rng.normal(size=c.shape)))
    return u, llr.astype(np.float32)


class TestSumproductFast:
    @pytest.mark.parametrize("schedule", ["flooding", "layered"])
    def test_bitexact_golden_jnp_pallas(self, small_code, schedule):
        """golden == XLA path bit-exactly; sumproduct-fast is the XLA
        path's alone: the GPU kernel refuses it and the backend policy
        routes it to the XLA path on every backend."""
        from tpu_ldpc import backend
        from tpu_ldpc.sim.mc import DecodeCfg

        rng = np.random.default_rng(1)
        llr = rng.normal(0.5, 2.0, (32, small_code.n)).astype(np.float32) * 3

        gb, gok, git = golden_decode(
            small_code.H, llr, algo="sumproduct-fast", iters=12,
            schedule=schedule, dtype=np.float32,
        )
        jf = build_decoder(small_code, algo="sumproduct-fast", iters=12,
                           schedule=schedule)
        jb, jok, jit_ = map(np.asarray, jf(llr))
        for a, b in ((gb, jb), (gok, jok), (git, jit_)):
            assert np.array_equal(a, b)
        with pytest.raises(ValueError):
            build_pallas_decoder(small_code, algo="sumproduct-fast",
                                 schedule=schedule, interpret=True)
        cfg = DecodeCfg(algo="sumproduct-fast", schedule=schedule)
        assert backend.choose_decoder(small_code, cfg).impl == "jnp"

    @pytest.mark.deep
    def test_fer_between_minsum_and_sumproduct(self, small_code):
        """Paired-noise FER ordering: SP <= SP-fast, SP-fast < minsum
        by a margin (the point of the approximation)."""
        u, llr = _noisy_llrs(small_code, 1024, 2.5, seed=2)
        fers = {}
        for algo in ("minsum", "sumproduct-fast", "sumproduct"):
            f = build_decoder(small_code, algo=algo, iters=20)
            b, ok, _ = map(np.asarray, f(llr))
            fers[algo] = (b[:, : small_code.k] != u).any(axis=1).mean()
        assert fers["sumproduct-fast"] <= fers["minsum"]
        # within MC slack of exact SP on the same noise
        assert fers["sumproduct-fast"] <= fers["sumproduct"] + 0.02

    def test_ctilde_approximates_log1pexp(self):
        from tpu_ldpc.golden.decoder import _ctilde

        x = np.linspace(0.0, 8.0, 200).astype(np.float32)
        exact = np.log1p(np.exp(-x.astype(np.float64)))
        approx = _ctilde(x, np.float32).astype(np.float64)
        assert np.max(np.abs(exact - approx)) < 0.05

    def test_quant_rejected(self, small_code):
        with pytest.raises(ValueError):
            build_decoder(small_code, algo="sumproduct-fast", quant_bits=6)


class TestTwoPhase:
    def test_equals_single_pass(self, small_code):
        _, llr = _noisy_llrs(small_code, 128, 3.0, seed=0)
        ref = build_pallas_decoder(small_code, iters=8, early_stop=True,
                                   interpret=True)
        tp = build_twophase_decoder(small_code, iters=8, phase1_iters=3,
                                    budget=128, interpret=True)
        for a, b in zip(map(np.asarray, ref(llr)),
                        map(np.asarray, tp(llr))):
            assert np.array_equal(a, b)

    def test_overflow_fallback_exact(self, small_code):
        """More stragglers than the budget -> full-batch fallback, still
        bit-identical."""
        _, llr = _noisy_llrs(small_code, 128, 0.0, seed=1)
        ref = build_pallas_decoder(small_code, iters=8, early_stop=True,
                                   interpret=True)
        tp = build_twophase_decoder(small_code, iters=8, phase1_iters=2,
                                    budget=8, interpret=True)
        # sanity: the overflow condition actually triggers
        ok1 = np.asarray(build_pallas_decoder(
            small_code, iters=2, early_stop=True, interpret=True)(llr)[1])
        assert (~ok1).sum() > 8
        for a, b in zip(map(np.asarray, ref(llr)),
                        map(np.asarray, tp(llr))):
            assert np.array_equal(a, b)

    @pytest.mark.deep
    def test_spfast_twophase(self, small_code):
        """Redundant-axis coverage (deep): the compaction machinery is
        algo-agnostic (it wraps any built kernel pair), and the default
        run already pins it for min-sum (flooding + layered) and exact
        SP (layered); spfast itself is a kept negative (DESIGN.md §3)."""
        _, llr = _noisy_llrs(small_code, 128, 3.0, seed=4)
        ref = build_decoder(small_code, algo="sumproduct-fast", iters=8,
                            early_stop=True)
        tp = build_twophase_decoder(small_code, iters=8, phase1_iters=3,
                                    budget=128, algo="sumproduct-fast",
                                    impl="jnp")
        for a, b in zip(map(np.asarray, ref(llr)),
                        map(np.asarray, tp(llr))):
            assert np.array_equal(a, b)

    def test_layered_twophase(self, small_code):
        """VERDICT r2 #1: layered-schedule two-phase compaction is
        bit-identical to the single-pass layered ET decoder."""
        _, llr = _noisy_llrs(small_code, 128, 3.0, seed=5)
        ref = build_pallas_decoder(small_code, iters=8, early_stop=True,
                                   schedule="layered", interpret=True)
        tp = build_twophase_decoder(small_code, iters=8, phase1_iters=3,
                                    budget=128, schedule="layered",
                                    interpret=True)
        for a, b in zip(map(np.asarray, ref(llr)),
                        map(np.asarray, tp(llr))):
            assert np.array_equal(a, b)

    def test_phase1_clamped_to_iters(self, small_code):
        """Review r3 regression: phase1_iters > iters must be clamped.
        Unclamped, lanes converging in (iters, K] kept phase-1's
        ok=True / iu > iters — a silent bit-identity violation that
        only shows when budget < batch (phase 2 re-decodes every lane
        otherwise, masking it)."""
        _, llr = _noisy_llrs(small_code, 256, 3.0, seed=11)
        ref = build_pallas_decoder(small_code, iters=4, early_stop=True,
                                   interpret=True)
        tp = build_twophase_decoder(small_code, iters=4, phase1_iters=16,
                                    budget=128, interpret=True)
        rb, rok, riu = map(np.asarray, ref(llr))
        assert riu.max() <= 4
        for a, b in zip((rb, rok, riu), map(np.asarray, tp(llr))):
            assert np.array_equal(a, b)

    def test_report_fallback(self, small_code):
        """VERDICT r2 #3: the fallback indicator distinguishes a
        compacted decode (n_unconv <= budget) from a forced full-batch
        fallback (n_unconv > budget), with outputs unchanged."""
        # easy SNR: few stragglers after 3 iters -> no fallback.  budget
        # 64 < batch 128 so the bound is NON-vacuous (ADVICE r3: at
        # budget==batch, n_unconv <= budget could never fail); measured
        # n_unconv here is 42.
        _, llr = _noisy_llrs(small_code, 128, 3.0, seed=6)
        tp = build_twophase_decoder(small_code, iters=8, phase1_iters=3,
                                    budget=64, interpret=True,
                                    report_fallback=True)
        plain = build_twophase_decoder(small_code, iters=8, phase1_iters=3,
                                       budget=64, interpret=True)
        b, ok, iu, n_unconv = tp(llr)
        assert int(n_unconv) <= 64
        for a, c in zip(map(np.asarray, (b, ok, iu)),
                        map(np.asarray, plain(llr))):
            assert np.array_equal(a, c)
        # hopeless SNR + tiny budget: forced fallback is visible
        _, llr0 = _noisy_llrs(small_code, 128, 0.0, seed=7)
        tp0 = build_twophase_decoder(small_code, iters=8, phase1_iters=2,
                                     budget=8, interpret=True,
                                     report_fallback=True)
        _, _, _, n0 = tp0(llr0)
        assert int(n0) > 8  # fallback fired and is observable

    def test_quant_forwarded_through_api(self, small_code):
        """ADVICE r2 medium regression: impl='twophase' must forward
        quant_bits (it was silently dropped, returning float results
        labeled quantized)."""
        from tpu_ldpc.decode.api import decode

        _, llr = _noisy_llrs(small_code, 128, 2.0, seed=8)
        outq = decode(small_code, llr, iters=8, impl="twophase",
                      quant_bits=5, quant_step=0.5)
        # the reference is built EXPLICITLY quantized: had the api
        # dropped quant_bits, outq would be a float decode and could
        # not reproduce the quantized trajectories below (fixed-point
        # modes are the XLA path's)
        ref = build_decoder(small_code, iters=8, early_stop=True,
                            quant_bits=5, quant_step=0.5)
        rb, rok, riu = map(np.asarray, ref(llr))
        for a, b in zip(map(np.asarray, outq), (rb, rok, riu)):
            assert np.array_equal(a, b)
        # sanity: quantization visibly bends trajectories at this
        # operating point (otherwise the equality above proves nothing)
        fl = build_pallas_decoder(small_code, iters=8, early_stop=True,
                                  interpret=True)
        assert not np.array_equal(np.asarray(fl(llr)[2]), riu)

    def test_tune_phase1_iters(self, small_code):
        """The measured-distribution tuner returns a sane (K, budget):
        K below the full budget, budget a 128-multiple covering the
        observed stragglers with margin."""
        from tpu_ldpc.decode.twophase import tune_phase1_iters

        K, budget, stats = tune_phase1_iters(
            small_code, ebn0_db=3.0, batch=128, iters=8, seed=9,
            interpret=True)
        assert 1 <= K <= 8
        assert budget % 128 == 0 and budget >= 128
        assert stats["n_stragglers"] <= budget
        assert stats["mean_iters"] < 8

    def test_sumproduct_layered_twophase(self, small_code):
        """Exact SP + layered schedule through two-phase compaction is
        bit-identical to the single-pass layered SP ET decoder."""
        _, llr = _noisy_llrs(small_code, 128, 3.0, seed=10)
        ref = build_pallas_decoder(small_code, algo="sumproduct",
                                   iters=8, early_stop=True,
                                   schedule="layered", interpret=True)
        tp = build_twophase_decoder(small_code, iters=8, phase1_iters=3,
                                    budget=128, algo="sumproduct",
                                    schedule="layered", interpret=True)
        for a, b in zip(map(np.asarray, ref(llr)),
                        map(np.asarray, tp(llr))):
            assert np.array_equal(a, b)
