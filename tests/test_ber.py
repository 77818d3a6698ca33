"""Monte-Carlo harness tests (SURVEY.md §4.4): paired-seed statistics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_ldpc.channel import awgn_llrs, noise_sigma2
from tpu_ldpc.codes import LdpcCode, make_base_graph
from tpu_ldpc.encode import encode
from tpu_ldpc.golden import decode as golden_decode
from tpu_ldpc.sim import DecodeCfg, build_mc_step, fold_key, run_ber


def toy_code():
    return LdpcCode.from_base_graph(make_base_graph(4, 8, 4, seed=7), 4, "toy")


def test_run_ber_deterministic():
    code = toy_code()
    cfg = DecodeCfg(algo="minsum", iters=20, impl="jnp")
    kw = dict(
        cfg=cfg, batch=64, target_frame_errors=10, max_frames=2048, seed=3
    )
    r1 = run_ber(code, [3.0], **kw)
    r2 = run_ber(code, [3.0], **kw)
    assert r1[0].frames == r2[0].frames
    assert r1[0].bit_errors == r2[0].bit_errors
    assert r1[0].frame_errors == r2[0].frame_errors
    assert r1[0].iter_sum == r2[0].iter_sum


def test_fer_monotone_in_snr():
    code = toy_code()
    cfg = DecodeCfg(algo="minsum", iters=30, impl="jnp")
    res = run_ber(
        code, [1.0, 7.0], cfg=cfg, batch=128,
        target_frame_errors=30, max_frames=4096, seed=1,
    )
    assert res[0].fer > res[1].fer
    assert res[0].frames > 0 and res[1].frames > 0
    # error accounting: frame errors split into detected + undetected,
    # and every undetected error is also a frame error
    for r in res:
        assert r.undetected <= r.frame_errors
        assert r.frame_errors <= r.detected + r.undetected


def test_mc_step_counters_match_golden():
    """Rebuild the exact frames of one MC step on host; compare counters."""
    code = toy_code()
    cfg = DecodeCfg(algo="minsum", iters=20, impl="jnp")
    batch, ebn0, seed, snr_idx, batch_ctr = 32, 4.0, 11, 0, 5
    step = build_mc_step(code, cfg, batch)
    counters = np.asarray(jax.device_get(step(
        jnp.asarray(seed, jnp.int32), jnp.asarray(snr_idx, jnp.int32),
        jnp.asarray(ebn0, jnp.float32), jnp.asarray(batch_ctr, jnp.int32),
    )))

    # host-side replay of the same PRNG stream
    key_u, key_n = jax.random.split(fold_key(seed, snr_idx, batch_ctr))
    u = np.asarray(
        jax.random.bernoulli(key_u, 0.5, (batch, code.k))
    ).astype(np.uint8)
    c = np.asarray(encode(code, u))
    llr = np.asarray(awgn_llrs(key_n, c, ebn0, code.rate))
    gb, gok, git = golden_decode(
        code.H, llr, algo="minsum", iters=20, alpha=0.75, dtype=np.float32
    )
    wrong = gb[:, : code.k] != u
    assert counters[0] == batch
    assert counters[1] == wrong.sum()
    assert counters[2] == wrong.any(axis=1).sum()
    assert counters[3] == (~gok).sum()
    assert counters[5] == git.sum()


def test_sigma_convention():
    # Eb/N0 = 0 dB, rate 1/2 => sigma^2 = 1
    assert abs(noise_sigma2(0.0, 0.5) - 1.0) < 1e-12
    # known reference point: rate 1/2 @ 2 dB => sigma^2 = 1/10^0.2
    assert abs(noise_sigma2(2.0, 0.5) - 10 ** -0.2) < 1e-12


def test_high_snr_point_sane():
    """At 8 dB the toy code's FER should be tiny and mean iters near 0-2."""
    code = toy_code()
    cfg = DecodeCfg(algo="minsum", iters=30, impl="jnp")
    res = run_ber(
        code, [8.0], cfg=cfg, batch=256,
        target_frame_errors=5, max_frames=2048, seed=2,
    )[0]
    assert res.fer < 0.05
    assert res.mean_iters < 5


def test_fault_injection_detected():
    """SURVEY §5: corrupting decoder outputs must show up in the counters
    (frame errors + undetected errors rise; accounting stays consistent)."""
    import jax.numpy as jnp

    from tpu_ldpc.sim import mc

    code = toy_code()
    cfg = DecodeCfg(algo="minsum", iters=20, impl="jnp")

    def run_step():
        return np.asarray(jax.device_get(build_mc_step(code, cfg, 64)(
            jnp.asarray(1, jnp.int32), jnp.asarray(0, jnp.int32),
            jnp.asarray(8.0, jnp.float32), jnp.asarray(0, jnp.int32),
        )))

    clean = run_step()

    def flip_bits(key, bits, ok, iters_used):
        flip = jax.random.bernoulli(key, 0.05, bits.shape)
        return bits ^ flip.astype(jnp.uint8), ok, iters_used

    mc._FAULT_HOOK = flip_bits
    mc.build_mc_step.cache_clear()
    try:
        faulty = run_step()
    finally:
        mc._FAULT_HOOK = None
        mc.build_mc_step.cache_clear()

    assert faulty[1] > clean[1]          # bit errors jump
    assert faulty[2] > clean[2]          # frame errors jump
    assert faulty[4] >= clean[4]         # corrupted-but-"ok" frames counted
    assert faulty[2] <= faulty[3] + faulty[4]  # accounting invariant


def test_steps_per_call_grouping_invariant():
    """Counter totals are identical for any steps_per_call grouping."""
    code = toy_code()
    cfg = DecodeCfg(algo="minsum", iters=15, impl="jnp")
    kw = dict(cfg=cfg, batch=32, target_frame_errors=1000,
              max_frames=256, seed=13)
    r1 = run_ber(code, [3.0], steps_per_call=1, **kw)[0]
    r2 = run_ber(code, [3.0], steps_per_call=4, **kw)[0]
    assert r1.frames == r2.frames
    assert r1.bit_errors == r2.bit_errors
    assert r1.frame_errors == r2.frame_errors
    assert r1.iter_sum == r2.iter_sum


def test_judged_waterfall_fixture_consistency():
    """Frozen sweep fixture (SURVEY §4.8): sanity-check shape and
    anchors.  (On a GPU, chip_smoke.py re-runs the sweep with the same
    seeds and checks its FER against this fixture's interval; on CPU we
    check the frozen curve.)"""
    import os

    from tpu_ldpc.report.waterfall import load_csv

    path = os.path.join(os.path.dirname(__file__), "fixtures",
                        "judged_minsum50.csv")
    text = "\n".join(
        ln for ln in open(path).read().splitlines()
        if not ln.startswith("#")
    )
    rows = load_csv(text)
    fer = {r["ebn0_db"]: r["fer"] for r in rows}
    # monotone decreasing
    xs = sorted(fer)
    assert all(fer[a] >= fer[b] for a, b in zip(xs, xs[1:]))
    # literature-envelope anchors: FER ~1e-2 around 1.5-2 dB,
    # <= 1e-3 by 2.5 dB, no Shannon violation (FER must be high at 0.2 dB
    # equivalent -- here: high FER at 1.0 dB)
    assert fer[1.0] > 0.3
    assert 3e-3 <= fer[2.0] <= 3e-2
    assert fer[2.5] <= 1e-3
    assert fer[3.0] <= 1e-4
