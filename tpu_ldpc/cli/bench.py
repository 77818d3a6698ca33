"""`python -m tpu_ldpc.cli.bench` — decode throughput on one GPU
(SURVEY.md C13).

Measures decoded info bits/s (call stack §3.5) with the estimator shared
with bench.py (tpu_ldpc/benchcore.py).  The decoder is the backend
policy's choice (tpu_ldpc/backend.py); the record names it, the device
and the card's power limit.  Without a GPU it exits non-zero.
`--profile DIR` wraps the timed loop in a jax.profiler trace.
"""

from __future__ import annotations

import argparse
import json


def build_bench_decoder(
    code,
    impl: str = "auto",
    algo: str = "minsum",
    iters: int = 50,
    alpha: float = 0.75,
    schedule: str = "flooding",
    early_stop: bool = False,
    phase1_iters: int | None = None,
    compact_budget: int | None = None,
):
    """(implementation label, decode fn) for one benchmarked configuration.

    impl='twophase' is the two-phase straggler-compaction ET decoder
    (early_stop implied).  Unset knobs resolve from the cell's registry
    metadata (decode/knobs.py); the first-overflow warning stays OFF
    here, because a debug callback inside the device timing loop would
    serialize dispatches (an overflow shows in the number itself).
    """
    from tpu_ldpc import backend
    from tpu_ldpc.sim.mc import DecodeCfg

    cfg = DecodeCfg(algo=algo, iters=iters, alpha=alpha, schedule=schedule,
                    impl=impl)
    choice = backend.choose_decoder(code, cfg)
    if impl == "twophase":
        from tpu_ldpc.decode.knobs import resolve_twophase_knobs
        from tpu_ldpc.decode.twophase import build_twophase_decoder

        k, b, _src = resolve_twophase_knobs(
            code, schedule, phase1_iters, compact_budget)
        return f"twophase/{choice.impl}", build_twophase_decoder(
            code, iters=iters, phase1_iters=k, budget=b, impl=choice.impl,
            algo=algo, alpha=alpha, schedule=schedule,
        )
    if choice.impl == "pallas":
        from tpu_ldpc.decode.pallas_bp import build_pallas_decoder as build
    else:
        from tpu_ldpc.decode.reference import build_decoder as build
    return choice.impl, build(code, algo=algo, iters=iters, alpha=alpha,
                              schedule=schedule, early_stop=early_stop)


def bench_decode(code, fn, batch: int = 4096, ebn0_db: float = 2.0,
                 reps: int = 30):
    """Time `fn` on `batch` frames at `ebn0_db`; returns (seconds/batch,
    info bits/s), NaN when the delta is below the estimator's
    resolution."""
    from tpu_ldpc.benchcore import make_timer

    timer, _u = make_timer(code, batch, ebn0_db=ebn0_db,
                           inner=max(2, min(reps, 20)))
    dt = timer.measure(fn, reps=5)["median_s"]
    if dt <= 0:
        # the paired-delta jitter exceeds the decode itself: refuse to
        # print a nonsense number
        import sys

        print(
            f"warning: measured delta {dt*1e3:.4f} ms/batch is not "
            "positive — decode is below the estimator's resolution at "
            f"batch={batch}; use a larger batch or more iterations",
            file=sys.stderr,
        )
        return float("nan"), float("nan")
    return dt, batch * code.k / dt


def main(argv=None):
    p = argparse.ArgumentParser(description="decode throughput on one GPU")
    p.add_argument("--family", default="judged")
    p.add_argument("--rate", default="1/2")
    p.add_argument("--z", type=int, default=64)
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--iters", type=int, default=None,
                   help="iteration budget (default: the cell's tuned "
                        "registry metadata value for impl=twophase — "
                        "the (K, budget) knobs were tuned AT that "
                        "total-iters; else 50)")
    p.add_argument("--algo", default="minsum")
    p.add_argument("--schedule", default="flooding")
    p.add_argument("--early-stop", action="store_true")
    p.add_argument("--ebn0", type=float, default=None,
                   help="operating point (default: the cell's tuned "
                        "registry metadata point for impl=twophase, "
                        "else 2.0 — a rate-5/6 cell at 2.0 dB is all "
                        "stragglers and pays the fallback every "
                        "dispatch)")
    p.add_argument("--reps", type=int, default=30)
    p.add_argument("--impl", default="auto",
                   choices=["auto", "jnp", "pallas", "twophase"])
    p.add_argument("--phase1-iters", type=int, default=None,
                   help="impl=twophase: phase-1 iteration budget "
                        "(default: per-cell registry metadata)")
    p.add_argument("--compact-budget", type=int, default=None,
                   help="impl=twophase: phase-2 compacted batch size "
                        "(default: per-cell registry metadata)")
    p.add_argument("--profile", metavar="DIR")
    p.add_argument("--json", action="store_true", help="machine output")
    args = p.parse_args(argv)

    import jax

    from tpu_ldpc import backend
    from tpu_ldpc.cli.config import CodeSpec

    backend.require_gpu("python -m tpu_ldpc.cli.bench")
    backend.use_compile_cache()
    code = CodeSpec(family=args.family, rate=args.rate, Z=args.z).build()

    if args.ebn0 is None or args.iters is None:
        # the metadata operating point applies ONLY to impl=twophase
        # (its knobs were tuned at that point and overflow elsewhere);
        # every other impl keeps the documented defaults so numbers
        # stay comparable with prior captures (review r4).  iters too
        # (ADVICE r4): layered metadata is tuned at iters=25 — a
        # default of 50 would halve the recorded gbps despite
        # defaulting ebn0 from the same entry.
        entry = None
        if args.impl == "twophase":
            from tpu_ldpc.decode.knobs import registry_entry

            entry = registry_entry(code, args.schedule)
        if args.ebn0 is None:
            args.ebn0 = (entry or {}).get("ebn0_db", 2.0)
        if args.iters is None:
            args.iters = (entry or {}).get("iters", 50)

    ctx = None
    if args.profile:
        ctx = jax.profiler.trace(args.profile)
        ctx.__enter__()
    impl, fn = build_bench_decoder(
        code, impl=args.impl, algo=args.algo, iters=args.iters,
        schedule=args.schedule, early_stop=args.early_stop,
        phase1_iters=args.phase1_iters, compact_budget=args.compact_budget,
    )
    dt, thpt = bench_decode(code, fn, batch=args.batch, ebn0_db=args.ebn0,
                            reps=args.reps)
    if ctx is not None:
        ctx.__exit__(None, None, None)

    rec = {
        "code": code.name, "n": code.n, "k": code.k, "ebn0_db": args.ebn0,
        "algo": args.algo, "iters": args.iters, "schedule": args.schedule,
        "early_stop": args.early_stop, "batch": args.batch, "impl": impl,
        "device": backend.device_summary(),
        "gpu": backend.gpu_name_and_power_limit(),
        "ms_per_batch": dt * 1e3, "info_bits_per_s": thpt,
        "gbps": thpt / 1e9,
    }
    if args.json:
        # strict JSON: the below-resolution guard returns NaN, which
        # json.dumps would serialize as a bare `NaN` literal that
        # breaks downstream parsers (ADVICE r2) — emit null instead
        import math

        safe = {
            k: (None if isinstance(v, float) and not math.isfinite(v)
                else v)
            for k, v in rec.items()
        }
        print(json.dumps(safe))
    else:
        print(
            f"{code.name}: {args.algo} {args.iters} iters "
            f"({args.schedule}, early_stop={args.early_stop}) "
            f"batch={args.batch}, {impl} on {rec['device']['kind']} "
            f"({rec['gpu']}): "
            f"{dt*1e3:.2f} ms/batch -> {thpt/1e9:.3f} Gb/s info"
        )
    return rec


if __name__ == "__main__":
    main()
