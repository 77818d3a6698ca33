"""Per-cell twophase knob resolution (decode/knobs.py; VERDICT r3 #3).

Mis-sized knobs are measured to collapse throughput 2.2x via the
full-batch fallback, so impl='twophase' must resolve unset knobs from
the cell's registry metadata instead of judged-flooding constants —
and explicit caller knobs must always win.
"""

import numpy as np
import pytest

from tpu_ldpc.codes import LdpcCode, make_base_graph
from tpu_ldpc.decode.knobs import resolve_twophase_knobs


@pytest.fixture(scope="module")
def wifi_r56_z81():
    return LdpcCode.from_family("wifi", "5/6", 81)


def test_registry_lookup_measured_cell(wifi_r56_z81):
    """A cell's tuned registry knobs resolve by cell name."""
    k, b, src = resolve_twophase_knobs(wifi_r56_z81, "layered", None, None)
    assert (k, b, src) == (7, 384, "registry")


def test_judged_both_schedules():
    code = LdpcCode.judged()
    assert resolve_twophase_knobs(code, "layered", None, None) == (
        9, 768, "registry")
    assert resolve_twophase_knobs(code, "flooding", None, None) == (
        16, 512, "registry")


def test_explicit_always_wins(wifi_r56_z81):
    k, b, src = resolve_twophase_knobs(wifi_r56_z81, "layered", 11, 256)
    assert (k, b, src) == (11, 256, "explicit")


def test_partial_explicit_fills_from_registry(wifi_r56_z81):
    k, b, src = resolve_twophase_knobs(wifi_r56_z81, "layered", 11, None)
    assert (k, b, src) == (11, 384, "registry")
    k, b, src = resolve_twophase_knobs(wifi_r56_z81, "layered", None, 256)
    assert (k, b, src) == (7, 256, "registry")


def test_unknown_cell_rate_derived():
    """Cells without measured metadata get rate-anchored defaults:
    layered K 9/8/7 by rate band, flooding ~2x (judged anchor 16 vs 9),
    conservative budget 512."""
    lo = LdpcCode.from_base_graph(make_base_graph(4, 8, 8, seed=3), 8)
    assert lo.rate == 0.5
    assert resolve_twophase_knobs(lo, "layered", None, None) == (
        9, 512, "derived")
    assert resolve_twophase_knobs(lo, "flooding", None, None) == (
        16, 512, "derived")
    hi = LdpcCode.from_base_graph(
        make_base_graph(4, 24, 8, seed=5), 8, "custom_hi_rate")
    assert hi.rate > 0.79
    k, b, src = resolve_twophase_knobs(hi, "layered", None, None)
    assert (k, b, src) == (7, 512, "derived")


def test_api_resolves_and_arms_warning(wifi_r56_z81, monkeypatch):
    """build_decode_fn(impl='twophase') forwards registry knobs and
    arms warn_on_fallback for resolved (non-explicit) knobs only."""
    import tpu_ldpc.decode.twophase as tpmod
    from tpu_ldpc.decode.api import build_decode_fn
    from tpu_ldpc.sim.mc import DecodeCfg

    calls = []
    monkeypatch.setattr(
        tpmod, "build_twophase_decoder",
        lambda code, **kw: calls.append(kw) or (lambda llr: None))

    build_decode_fn(wifi_r56_z81, DecodeCfg(
        impl="twophase", schedule="layered", iters=25))
    assert calls[-1]["phase1_iters"] == 7
    assert calls[-1]["budget"] == 384
    assert calls[-1]["warn_on_fallback"] is True

    build_decode_fn(wifi_r56_z81, DecodeCfg(
        impl="twophase", schedule="layered", iters=25,
        phase1_iters=11, compact_budget=256))
    assert calls[-1]["phase1_iters"] == 11
    assert calls[-1]["budget"] == 256
    assert calls[-1]["warn_on_fallback"] is False


def test_warn_once_on_budget_overflow():
    """warn_on_fallback emits exactly one host warning when a dispatch
    overflows the budget (the ~2x perf cliff), none when it fits."""
    import warnings

    from tpu_ldpc.channel import noise_sigma2
    from tpu_ldpc.decode.twophase import build_twophase_decoder
    from tpu_ldpc.golden import encode as golden_encode

    code = LdpcCode.from_base_graph(make_base_graph(4, 8, 8, seed=3), 8)
    rng = np.random.default_rng(7)
    u = rng.integers(0, 2, (128, code.k)).astype(np.uint8)
    c = golden_encode(code.H, u)
    s2 = noise_sigma2(0.0, code.rate)  # hopeless SNR: many stragglers
    llr = ((2 / s2) * ((1.0 - 2.0 * c)
                       + np.sqrt(s2) * rng.normal(size=c.shape))
           ).astype(np.float32)
    tp = build_twophase_decoder(code, iters=8, phase1_iters=2, budget=8,
                                interpret=True, warn_on_fallback=True)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        tp(llr)
        tp(llr)  # second dispatch must NOT warn again
    msgs = [str(w.message) for w in rec if "twophase" in str(w.message)]
    assert len(msgs) == 1, msgs
    assert "budget 8" in msgs[0]

    # easy SNR within budget: no warning
    s2 = noise_sigma2(4.0, code.rate)
    llr2 = ((2 / s2) * ((1.0 - 2.0 * c)
                        + np.sqrt(s2) * rng.normal(size=c.shape))
            ).astype(np.float32)
    tp2 = build_twophase_decoder(code, iters=8, phase1_iters=4, budget=64,
                                 interpret=True, warn_on_fallback=True)
    with warnings.catch_warnings(record=True) as rec2:
        warnings.simplefilter("always")
        tp2(llr2)
    assert not [w for w in rec2 if "twophase" in str(w.message)]


def test_twophase_vmem_rejected_falls_back_with_warning(monkeypatch):
    """A code over the GPU kernel's capacity gets impl='twophase' built
    on the XLA path by the backend policy's explicit rule — no kernel
    rejection is caught and swallowed on the way."""
    import tpu_ldpc.decode.twophase as tpmod
    from tpu_ldpc import backend
    from tpu_ldpc.decode import pallas_bp
    from tpu_ldpc.decode.api import build_decode_fn
    from tpu_ldpc.sim.mc import DecodeCfg

    calls = []
    real = tpmod.build_twophase_decoder
    monkeypatch.setattr(tpmod, "build_twophase_decoder",
                        lambda code, **kw: calls.append(kw) or real(code,
                                                                    **kw))
    monkeypatch.setattr(backend, "on_gpu", lambda: True)
    monkeypatch.setattr(pallas_bp, "fits", lambda code: False)
    code = LdpcCode.from_base_graph(make_base_graph(4, 8, 8, seed=3), 8)
    cfg = DecodeCfg(impl="twophase", iters=8)
    assert backend.choose_decoder(code, cfg).reason == (
        "state over the kernel's capacity")
    fn = build_decode_fn(code, cfg)
    assert calls[-1]["impl"] == "jnp"
    llr = np.full((8, code.n), 4.0, np.float32)
    bits, ok, iu = fn(llr)
    assert np.asarray(bits).shape == (8, code.n)


def test_low_rate_derived_band():
    """Low-rate cells converge much slower (nr2_r15 mean ~11 layered
    iters at its operating point): the derived fallback must not hand
    them the rate-1/2 K=9, which overflows every dispatch."""
    lo = LdpcCode.from_base_graph(
        make_base_graph(16, 20, 8, seed=5), 8, "custom_low_rate")
    assert lo.rate < 0.35
    k, b, src = resolve_twophase_knobs(lo, "layered", None, None)
    # budget 1280 (not the rate>=1/2 512): the nr2_r15 anchor measured
    # 612 stragglers past K — 512 would overflow every dispatch
    assert (k, b, src) == (14, 1280, "derived")


def test_nr2_flagship_measured_knobs():
    from tpu_ldpc.codes.nrlike import nrlike_code

    code = nrlike_code("1/5", 64, bg=2)
    assert resolve_twophase_knobs(code, "layered", None, None) == (
        14, 1280, "registry")
