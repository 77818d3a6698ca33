"""Per-cell two-phase knob resolution (SURVEY.md C9/C14; VERDICT r3 #3).

The two-phase ET decoder's (phase1_iters K, compact budget B) are
operating-point parameters: a budget the stragglers overflow sends
every batch through the full-batch fallback and roughly doubles its
cost (K=8/B=512 on the judged layered cell).  Before this module the
tuned values lived only in artifacts and scripts, and DecodeCfg
defaulted every cell to the judged-code FLOODING knobs — a foot-gun
for anyone decoding a family cell with --impl twophase.

Resolution order for a knob the caller left unset:
  1. registry metadata (codes/data/twophase_knobs.json): (K, B) per
     (cell, schedule), sized from the measured iteration distribution
     at the cell's operating point (decode/twophase.py
     tune_phase1_iters);
  2. rate-derived defaults: K from the cell's code rate (higher rate
     => faster BP convergence at its operating point => smaller K;
     anchored on the measured cells), budget a conservative 512
     (overflow falls back to a correct-but-2x-slower full-batch decode,
     now warned about — see build_twophase_decoder(warn_on_fallback)).

Explicit caller knobs always win and are never second-guessed.
"""

from __future__ import annotations

import functools
import json
import os

_KNOBS_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "codes", "data", "twophase_knobs.json")


@functools.lru_cache(maxsize=1)
def _load_table() -> dict:
    if not os.path.exists(_KNOBS_PATH):
        return {}
    with open(_KNOBS_PATH) as f:
        return json.load(f).get("cells", {})


def registry_entry(code, schedule: str) -> dict | None:
    """Full registry metadata entry for (cell, schedule), or None.

    Beyond (K, budget) the entry records the OPERATING CONTEXT the
    knobs were tuned in — `iters` (total iteration budget) and
    `ebn0_db` (tuned point).  Knobs are only valid near that context:
    sweeping well below the tuned Eb/N0 overflows the phase-2 budget
    on essentially every dispatch (correct but ~2x slower via the
    full-batch fallback), and a different total-iters changes the
    phase-1/phase-2 split the (K, budget) pair was chosen for
    (ADVICE r4).  Callers defaulting an operating point (cli/bench)
    should take iters AND ebn0_db from here, not just the knobs.
    """
    return _load_table().get(getattr(code, "name", ""), {}).get(schedule)


def _derived_k(rate: float, schedule: str) -> int:
    """Rate-derived phase-1 budget for cells without measured knobs.

    Layered anchors (measured): rate 1/5 -> K 14 (low-rate BP
    converges MUCH slower — nr2_r15 mean 11 layered iters at its
    operating point vs ~6.5 for rate-1/2 cells; the old rate-1/2 K=9
    would overflow every dispatch), rate 1/2 -> K 9-10, rate 5/6 ->
    K 7.  Flooding converges ~2x slower per iteration (layered-25 ==
    flooding-50 FER), so its K is ~2x the layered value (judged
    flooding measured K=16 vs layered K=9).
    """
    if rate < 0.35:
        k = 14
    elif rate < 0.58:
        k = 9
    elif rate < 0.79:
        k = 8
    else:
        k = 7
    return k if schedule == "layered" else 2 * k - 2


def _derived_budget(rate: float) -> int:
    """Derived compaction budget.  512 is conservative for rate >=
    ~1/2 cells, but the low-rate anchor (nr2_r15) measured 612
    stragglers past its tuned K — a 512 budget there would overflow
    on essentially EVERY dispatch (the exact 2x cliff this module
    exists to prevent), so the low-rate band carries the measured
    ~1280 need (review r4)."""
    return 1280 if rate < 0.35 else 512


def resolve_twophase_knobs(code, schedule: str,
                           phase1_iters: int | None,
                           compact_budget: int | None):
    """Fill in unset two-phase knobs for this code cell.

    code: LdpcCode (its .name keys the registry metadata, its .rate
      feeds the derived fallback).
    Returns (phase1_iters, compact_budget, source) where source is
    'explicit', 'registry', or 'derived' — the loosest origin among the
    two knobs (explicit < registry < derived), so callers can decide
    whether to enable fallback warnings.
    """
    if phase1_iters is not None and compact_budget is not None:
        return int(phase1_iters), int(compact_budget), "explicit"
    entry = _load_table().get(getattr(code, "name", ""), {}).get(schedule)
    if entry is not None:
        k = phase1_iters if phase1_iters is not None else entry["K"]
        b = compact_budget if compact_budget is not None else entry["budget"]
        return int(k), int(b), "registry"
    rate = float(getattr(code, "rate", 0.5))
    k = (phase1_iters if phase1_iters is not None
         else _derived_k(rate, schedule))
    b = (compact_budget if compact_budget is not None
         else _derived_budget(rate))
    return int(k), int(b), "derived"
