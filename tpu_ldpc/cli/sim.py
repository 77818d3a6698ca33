"""`python -m tpu_ldpc.sim` / `tpu_ldpc.cli.sim` — BER/FER sweep CLI.

Call stack §3.1/§3.3.  Usage:

    python -m tpu_ldpc.cli.sim --ebn0 1.0 2.0 3.0 --algo minsum \
        --family wifi --rate 1/2 --z 27 --target-fe 100 \
        --csv out.csv --checkpoint sweep.json [--mesh] [--profile DIR]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def build_parser():
    p = argparse.ArgumentParser(description="QC-LDPC Monte-Carlo BER/FER sweep")
    p.add_argument("--config", help="JSON config file")
    p.add_argument("--set", action="append", default=[], metavar="K=V",
                   help="dotted config override, e.g. decode.alpha=0.8")
    # common shortcuts (equivalent to --set forms)
    p.add_argument("--family", choices=["judged", "wifi", "wimax", "nr",
                                        "nr2", "sc", "alist"])
    p.add_argument("--sc-length", type=int, help="SC chain length L (family=sc)")
    p.add_argument("--rate")
    p.add_argument("--z", type=int)
    p.add_argument("--alist")
    p.add_argument("--ebn0", type=float, nargs="+")
    p.add_argument("--algo", choices=["minsum", "sumproduct", "sumproduct-fast", "bitflip", "wbf"])
    p.add_argument("--iters", type=int)
    p.add_argument("--alpha", type=float)
    p.add_argument("--beta", type=float)
    p.add_argument("--schedule", choices=["flooding", "layered", "windowed"])
    p.add_argument("--window-sweep", choices=["flooding", "layered"],
                   help="within-window schedule for --schedule "
                        "windowed (layered: ~2x faster at equal or "
                        "better FER — measured r5)")
    p.add_argument("--window", type=int,
                   help="window width in block-rows (schedule=windowed)")
    p.add_argument("--quant-bits", type=int,
                   help="fixed-point emulation: message width in bits "
                        "(min-sum only; golden contract in golden/decoder.py)")
    p.add_argument("--quant-step", type=float,
                   help="fixed-point emulation: LSB step (default 0.5)")
    p.add_argument("--quant-post-bits", type=int,
                   help="fixed-point emulation: APP width (default bits+2)")
    p.add_argument("--puncture-blocks", type=int, nargs="+", metavar="B",
                   help="block-columns to puncture (rate adaptation)")
    p.add_argument("--crc", choices=["crc8", "crc16", "crc24", "crc32"],
                   help="attach an outer CRC to the info block and "
                        "gate detected/undetected counters on it "
                        "(codes/crc.py)")
    p.add_argument("--shorten-blocks", type=int, nargs="+", metavar="B",
                   help="info block-columns to shorten (rate adaptation)")
    p.add_argument("--impl", choices=["auto", "jnp", "pallas", "twophase"])
    p.add_argument("--phase1-iters", type=int,
                   help="impl=twophase: phase-1 iteration budget K "
                        "(tune with decode.twophase.tune_phase1_iters)")
    p.add_argument("--compact-budget", type=int,
                   help="impl=twophase: compacted phase-2 batch size "
                        "(128-multiple; too small -> 2x fallback cost)")
    p.add_argument("--batch", type=int)
    p.add_argument("--target-fe", type=int)
    p.add_argument("--max-frames", type=int)
    p.add_argument("--seed", type=int)
    p.add_argument("--mesh", action="store_true",
                   help="shard the batch over all devices (psum counters)")
    p.add_argument("--checkpoint", help="sweep state file (resume if exists)")
    p.add_argument("--csv", help="write waterfall CSV here")
    p.add_argument("--jsonl", help="write per-point JSONL records here")
    p.add_argument("--step-jsonl", help="write per-dispatch JSONL records here")
    p.add_argument("--find-fer", type=float, metavar="FER",
                   help="instead of sweeping, bisect for the Eb/N0 at "
                        "this target FER (range = min/max of --ebn0)")
    p.add_argument("--profile", metavar="DIR",
                   help="capture a jax.profiler trace of the sweep into DIR")
    return p


def args_to_config(args):
    from tpu_ldpc.cli.config import SimConfig

    overrides = list(args.set)
    direct = {
        "code.family": args.family, "code.rate": args.rate, "code.Z": args.z,
        "code.path": args.alist, "code.L": args.sc_length,
        "decode.algo": args.algo, "decode.iters": args.iters,
        "decode.alpha": args.alpha, "decode.beta": args.beta,
        "decode.schedule": args.schedule, "decode.impl": args.impl,
        "decode.window": args.window,
        "decode.window_sweep": args.window_sweep,
        "decode.quant_bits": args.quant_bits,
        "decode.quant_step": args.quant_step,
        "decode.quant_post_bits": args.quant_post_bits,
        "decode.phase1_iters": args.phase1_iters,
        "decode.compact_budget": args.compact_budget,
        "run.batch": args.batch, "run.target_frame_errors": args.target_fe,
        "run.max_frames": args.max_frames, "run.seed": args.seed,
        "run.state_path": args.checkpoint, "run.out_csv": args.csv,
        "run.jsonl": args.jsonl,
        "run.step_jsonl": args.step_jsonl,
        "channel.crc": args.crc,
    }
    for k, v in direct.items():
        if v is not None:
            overrides.append(f"{k}={json.dumps(v)}")
    if args.ebn0:
        overrides.append(f"channel.ebn0_grid={json.dumps(args.ebn0)}")
    if args.puncture_blocks:
        overrides.append(
            f"channel.puncture_blocks={json.dumps(args.puncture_blocks)}")
    if args.shorten_blocks:
        overrides.append(
            f"channel.shorten_blocks={json.dumps(args.shorten_blocks)}")
    if args.mesh:
        overrides.append("run.use_mesh=true")
    return SimConfig.from_sources(args.config, overrides)


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = args_to_config(args)

    from tpu_ldpc.report.waterfall import waterfall_csv, waterfall_table
    from tpu_ldpc.sim.mc import run_ber
    from tpu_ldpc.sim.state import SweepState

    code = cfg.code.build()
    adapt = cfg.channel.build_adapt(code)
    chash = cfg.config_hash()
    state = (
        SweepState(cfg.run.state_path, chash) if cfg.run.state_path else None
    )
    mesh = None
    if cfg.run.use_mesh:
        from tpu_ldpc.dist.mesh import init_distributed, make_mesh

        init_distributed()
        mesh = make_mesh()

    profile_ctx = None
    if args.profile:
        import jax

        profile_ctx = jax.profiler.trace(args.profile)
        profile_ctx.__enter__()

    if args.find_fer is not None:
        from tpu_ldpc.sim.search import find_ebn0_at_fer

        grid = cfg.channel.ebn0_grid
        t0 = time.time()
        sr = find_ebn0_at_fer(
            code, args.find_fer, cfg=cfg.decode,
            lo=min(grid), hi=max(grid),
            target_frame_errors=cfg.run.target_frame_errors,
            batch=cfg.run.batch, seed=cfg.run.seed, mesh=mesh,
            adapt=adapt, progress=True,
        )
        status = "converged" if sr.converged else "OUT OF RANGE"
        print(f"\nEb/N0 @ FER {args.find_fer:.2e}: {sr.ebn0_db:.3f} dB "
              f"(bracket [{sr.bracket[0]:.3f}, {sr.bracket[1]:.3f}], "
              f"{status}, {len(sr.probes)} probes, "
              f"wall={time.time() - t0:.1f}s)")
        return sr

    t0 = time.time()
    results = run_ber(
        code,
        cfg.channel.ebn0_grid,
        cfg=cfg.decode,
        batch=cfg.run.batch,
        target_frame_errors=cfg.run.target_frame_errors,
        max_frames=cfg.run.max_frames,
        seed=cfg.run.seed,
        mesh=mesh,
        progress=True,
        state=state,
        step_log=cfg.run.step_jsonl or None,
        adapt=adapt,
        crc=cfg.channel.crc,
    )
    wall = time.time() - t0
    if profile_ctx is not None:
        profile_ctx.__exit__(None, None, None)

    if adapt is not None:
        k_eff, n_tx = adapt.dims(code.n, code.k)
        print(f"rate adaptation: punctured={len(adapt.puncture)} "
              f"shortened={len(adapt.shorten)} -> "
              f"(n_tx={n_tx}, k_eff={k_eff}, R_eff={k_eff / n_tx:.3f})")
    print(f"\ncode={code.name} (n={code.n}, k={code.k}, R={code.rate:.3f}) "
          f"algo={cfg.decode.algo} iters={cfg.decode.iters} "
          f"schedule={cfg.decode.schedule} config={chash} wall={wall:.1f}s\n")
    print(waterfall_table(results))
    if cfg.run.out_csv:
        with open(cfg.run.out_csv, "w") as f:
            f.write(f"# config_hash={chash}\n")
            f.write(waterfall_csv(results))
        print(f"wrote {cfg.run.out_csv}")
    if cfg.run.jsonl:
        with open(cfg.run.jsonl, "a") as f:
            for r in results:
                rec = {"config_hash": chash, "code": code.name,
                       "ebn0_db": r.ebn0_db, "frames": r.frames,
                       "bit_errors": r.bit_errors,
                       "frame_errors": r.frame_errors,
                       "detected": r.detected, "undetected": r.undetected,
                       "iter_sum": r.iter_sum, "fer": r.fer, "ber": r.ber,
                       "mean_iters": r.mean_iters, "wall_s": r.wall_s}
                f.write(json.dumps(rec) + "\n")
    return results


def entry():
    """Command-line entry: the compile cache by the backend policy, then
    the sweep."""
    from tpu_ldpc import backend

    backend.use_compile_cache()
    return main()


if __name__ == "__main__":
    entry()
