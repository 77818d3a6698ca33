#!/usr/bin/env python
"""Smoke run of the decode and Monte-Carlo path on one GPU.

    python chip_smoke.py                # one card: phases 0-4
    python chip_smoke.py --four-cards   # only the 4-card data-parallel
                                        # Monte-Carlo path (phase 5)

One process; it starts no other JAX process.  Each phase prints one line
(or a few) to stdout; a failed check exits non-zero with the reason on
stderr.  The last line of stdout is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
Without a GPU, or outside a checkout of this repository, it exits
non-zero and prints no result.

Phases:
  0  device: platform, kind, count, and nvidia-smi's name/power limit
  1  compile, in parallel threads, every batch-4096 decoder the later
     phases run (judged, wifi_r12_z81, wimax_r56_z96) and print the
     main-path decoder's memory analysis; the golden NumPy decodes of
     phase 2 run meanwhile in threads that stay off JAX
  2  correctness: min-sum bit-exact against golden float32 (the GPU
     kernel on all three codes, the XLA path on the judged code);
     kernel == XLA path on all 4096 frames; sum-product against golden
     by a stated tolerance; two-phase == single pass; encoder and CRC
     against golden
  3  main path end to end: cli.sim (impl=auto) against the frozen
     judged waterfall, one decode.api.decode call, one cli.bench run
  4  timing: the GPU kernel against what XLA makes of the reference
     decoder, decoded info Gb/s
"""

import argparse
import json
import math
import os
import statistics
import sys
import time

BATCH = 4096
GOLDEN_FRAMES = {"judged": 1024, "wifi_r12_z81": 128, "wimax_r56_z96": 128}
OPERATING_DB = {"judged": 2.0, "wifi_r12_z81": 2.0, "wimax_r56_z96": 3.6}
MINSUM_CFGS = (  # (label, builder kwargs)
    ("flooding50", dict(iters=50, early_stop=True)),
    ("flooding50-noET", dict(iters=50, early_stop=False)),
    ("layered25", dict(iters=25, schedule="layered", early_stop=True)),
)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def say(phase, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def codes():
    from tpu_ldpc.codes import LdpcCode

    return {
        "judged": LdpcCode.judged(),
        "wifi_r12_z81": LdpcCode.from_family("wifi", "1/2", 81),
        "wimax_r56_z96": LdpcCode.from_family("wimax", "5/6", 96),
    }


def noisy_llrs(code, batch, ebn0_db, seed=0):
    """(llr (batch, n) float32 on the host, info bits u): random frames
    through the golden encoder and a seeded AWGN channel."""
    import numpy as np

    from tpu_ldpc.channel import noise_sigma2
    from tpu_ldpc.golden import encode as golden_encode

    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (batch, code.k)).astype(np.uint8)
    x = 1.0 - 2.0 * golden_encode(code.H, u)
    s2 = noise_sigma2(ebn0_db, code.rate)
    y = x + np.sqrt(s2) * rng.normal(size=x.shape)
    return (2.0 / s2 * y).astype(np.float32), u


def same(a, b) -> bool:
    import numpy as np

    return all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(a, b))


def wilson(errors: int, frames: int, z: float = 1.96):
    p = errors / frames
    den = 1 + z * z / frames
    mid = (p + z * z / (2 * frames)) / den
    half = z * math.sqrt(p * (1 - p) / frames + z * z / (4 * frames ** 2))
    return mid - half / den, mid + half / den


def median_seconds(fn, x, reps: int = 7) -> float:
    """Median wall time of fn(x) to block_until_ready, after warm-up."""
    import jax

    for _ in range(2):
        jax.block_until_ready(fn(x))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(x))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def phase0(four_cards: bool) -> dict:
    import jax

    from tpu_ldpc import backend

    backend.require_gpu("chip_smoke.py")
    dev = backend.device_summary()
    if four_cards:
        check(dev["count"] >= 4, f"--four-cards needs 4 GPUs, have "
              f"{dev['count']}")
        dev["count"] = 4
    gpu = backend.gpu_name_and_power_limit().replace("\n", "; ")
    check(bool(gpu), "nvidia-smi gave no name/power limit")
    cache = backend.use_compile_cache()
    say(0, f"device {dev['platform']} kind={dev['kind']} "
        f"count={len(jax.devices())} jax={jax.__version__} cache={cache}")
    print(f"gpu: {gpu}", flush=True)
    return dev


def single_pass(impl):
    """The single-pass decoder builder for impl 'pallas' or 'jnp'."""
    from tpu_ldpc.decode.pallas_bp import build_pallas_decoder
    from tpu_ldpc.decode.reference import build_decoder

    return build_pallas_decoder if impl == "pallas" else build_decoder


def submit_golden(pool, cs) -> dict:
    """Start every golden NumPy decode phase 2 compares with, in threads
    that stay off JAX, so they run while the device decoders compile.
    Returns {key: (llr, info bits, future)}."""
    import numpy as np

    from tpu_ldpc.golden import decode as golden_decode

    jobs = {}
    for name, code in cs.items():
        llr, u = noisy_llrs(code, BATCH, OPERATING_DB[name])
        g = GOLDEN_FRAMES[name]
        for label, kw in MINSUM_CFGS:
            jobs[name, label] = (llr, u, pool.submit(
                golden_decode, code.H, llr[:g], algo="minsum",
                dtype=np.float32, **kw))
    code = cs["judged"]
    llr, u = noisy_llrs(code, BATCH, 2.0, seed=1)
    g = GOLDEN_FRAMES["judged"]
    jobs["judged", "sumproduct"] = (llr, u, pool.submit(
        golden_decode, code.H, llr[:g], algo="sumproduct", iters=50))
    return jobs


def phase1(cs, pool) -> dict:
    """Lower every batch-BATCH decoder phases 2 and 4 run, compile them
    in parallel threads (XLA and Triton compile outside the GIL), and
    print the main-path decoder's memory analysis.  Returns the compiled
    executables keyed (code, label, impl)."""
    import jax
    import jax.numpy as jnp

    from tpu_ldpc import backend
    from tpu_ldpc.decode.api import build_decode_fn
    from tpu_ldpc.sim.mc import DecodeCfg

    t0 = time.perf_counter()
    lowered = {}
    for name, code in cs.items():
        spec = jax.ShapeDtypeStruct((BATCH, code.n), jnp.float32)
        main = backend.choose_decoder(code, DecodeCfg()).impl
        impls = [main] + (["jnp"] if name == "judged" and main != "jnp"
                          else [])
        for label, kw in MINSUM_CFGS:
            for impl in impls:
                fn = (build_decode_fn(code, DecodeCfg(iters=50))
                      if label == "flooding50" and impl == main
                      else single_pass(impl)(code, **kw))
                lowered[name, label, impl] = fn.lower(spec)
    compiled = dict(zip(lowered, pool.map(lambda lo: lo.compile(),
                                          lowered.values())))
    for name, code in cs.items():
        impl = backend.choose_decoder(code, DecodeCfg(iters=50)).impl
        ma = compiled[name, "flooding50", impl].memory_analysis()
        say(1, f"{name} main path minsum flooding50 ET [{impl}] batch "
            f"{BATCH}: args {ma.argument_size_in_bytes} B, "
            f"out {ma.output_size_in_bytes} B, "
            f"temp {ma.temp_size_in_bytes} B")
    say(1, f"{len(compiled)} decoders compiled in "
        f"{time.perf_counter() - t0:.1f} s")
    return compiled


def phase2(cs, compiled, golden) -> None:
    import jax.numpy as jnp
    import numpy as np

    from tpu_ldpc import backend
    from tpu_ldpc.decode.knobs import resolve_twophase_knobs
    from tpu_ldpc.decode.twophase import build_twophase_decoder
    from tpu_ldpc.sim.mc import DecodeCfg

    # min-sum against golden float32: the main-path decoder on every code,
    # and on the judged code the XLA path too, against golden and
    # against the kernel on all BATCH frames
    for name, code in cs.items():
        impl = backend.choose_decoder(code, DecodeCfg()).impl
        g = GOLDEN_FRAMES[name]
        for label, _ in MINSUM_CFGS:
            llr, _, fut = golden[name, label]
            x = jnp.asarray(llr)
            out = compiled[name, label, impl](x)
            ref = fut.result()
            check(same([o[:g] for o in out], ref),
                  f"{name} {label}: {impl} != golden")
            msg = f"{impl} == golden on {g} frames"
            if (name, label, "jnp") in compiled and impl != "jnp":
                out_ref = compiled[name, label, "jnp"](x)
                check(same([o[:g] for o in out_ref], ref),
                      f"{name} {label}: XLA path != golden")
                check(same(out, out_ref),
                      f"{name} {label}: kernel != XLA on {BATCH} frames")
                msg += f"; XLA == golden; kernel == XLA on all {BATCH}"
            say(2, f"{name} minsum {label} @ {OPERATING_DB[name]} dB: "
                f"{msg} (syndrome failures "
                f"{1 - float(np.mean(np.asarray(out[1]))):.4f})")

    # sum-product: tanh/log lower differently on the GPU than in NumPy's
    # float64 golden, so agreement is statistical, not bit-exact
    code = cs["judged"]
    llr, u, fut = golden["judged", "sumproduct"]
    g = GOLDEN_FRAMES["judged"]
    impl = backend.choose_decoder(code, DecodeCfg(algo="sumproduct")).impl
    b, ok, _ = map(np.asarray, single_pass(impl)(
        code, algo="sumproduct", iters=50)(jnp.asarray(llr[:g])))
    gb, gok, _ = fut.result()
    agree = float(np.mean((ok == gok) & (b == gb).all(axis=1)))
    g_err = int((gb[:, : code.k] != u[:g]).any(axis=1).sum())
    k_err = int((b[:, : code.k] != u[:g]).any(axis=1).sum())
    lo, hi = wilson(g_err, g)
    check(agree >= 0.999, f"sum-product agreement {agree:.4f} < 0.999")
    check(lo <= k_err / g <= hi, f"sum-product FER {k_err}/{g} outside "
          f"golden's 95% Wilson interval [{lo:.4g}, {hi:.4g}]")
    say(2, f"judged sumproduct flooding50 [{impl}] vs golden float64 on "
        f"{g} frames: ok+bits agree on {agree:.4%}; FER {k_err}/{g} in "
        f"golden's Wilson [{lo:.4g}, {hi:.4g}] ({g_err}/{g})")

    # two-phase == single-pass ET, with the registry knobs (the layered
    # schedule's two-phase contract is pinned by the CPU tests)
    x = jnp.asarray(noisy_llrs(code, BATCH, 2.0, seed=2)[0])
    cfg = DecodeCfg(iters=50, impl="twophase")
    impl = backend.choose_decoder(code, cfg).impl
    k, bud, _ = resolve_twophase_knobs(code, "flooding", None, None)
    tp = build_twophase_decoder(code, iters=50, phase1_iters=k, budget=bud,
                                impl=impl, report_fallback=True)
    *out, n_unconv = tp(x)
    check(same(out, compiled["judged", "flooding50", impl](x)),
          "two-phase flooding != single-pass ET")
    say(2, f"twophase/{impl} flooding50 (K={k}, budget={bud}) == "
        f"single-pass ET on {BATCH} frames; phase-1 stragglers "
        f"{int(n_unconv)}")

    # encoder and CRC against golden
    from tpu_ldpc.codes import crc
    from tpu_ldpc.encode.encoder import build_encoder
    from tpu_ldpc.golden import encode as golden_encode

    rng = np.random.default_rng(3)
    for name, code in cs.items():
        uu = rng.integers(0, 2, (BATCH, code.k)).astype(np.uint8)
        check(np.array_equal(np.asarray(build_encoder(code)(uu)),
                             golden_encode(code.H, uu)),
              f"{name}: encoder != golden")
    spec = crc.get_spec("crc24")
    payload = rng.integers(0, 2, (BATCH, 488)).astype(np.uint8)
    frames = np.array(crc.make_crc_attacher(488, spec)(payload))
    check(np.array_equal(frames, crc.attach(payload, spec)),
          "CRC attach != golden")
    frames[::2, 7] ^= 1  # corrupt every other frame
    check(np.array_equal(np.asarray(crc.make_crc_checker(512, spec)(frames)),
                         crc.check(frames, spec)), "CRC check != golden")
    say(2, f"encoder == golden on {BATCH} frames of each code; crc24 "
        "attach/check == golden")


def phase3(cs, tmp: str) -> None:
    import jax.numpy as jnp
    import numpy as np

    from tpu_ldpc import backend
    from tpu_ldpc.cli import bench as cli_bench
    from tpu_ldpc.cli import sim as cli_sim
    from tpu_ldpc.decode import api
    from tpu_ldpc.sim.mc import DecodeCfg

    code = cs["judged"]
    # the frozen waterfall's own sweep: seed 0, batch 4096, and its grid
    # up to 2.0 dB, so the 2.0 dB point draws the fixture's PRNG streams
    impl = backend.choose_decoder(code, DecodeCfg()).impl
    res = cli_sim.main([
        "--family", "judged", "--ebn0", "1.0", "1.5", "2.0",
        "--algo", "minsum", "--iters", "50", "--impl", "auto",
        "--batch", str(BATCH), "--target-fe", "100", "--seed", "0",
        "--csv", os.path.join(tmp, "smoke_waterfall.csv"),
    ])
    fixture = {}
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "fixtures", "judged_minsum50.csv")
    for ln in open(path).read().splitlines():
        if ln[:1].isdigit():
            f = ln.split(",")
            fixture[float(f[0])] = tuple(int(v) for v in f[1:7])
    r = res[-1]
    got = (r.frames, r.bit_errors, r.frame_errors, r.detected,
           r.undetected, r.iter_sum)
    want = fixture[2.0]
    lo, hi = wilson(want[2], want[0])
    check(lo <= r.fer <= hi, f"cli.sim FER {r.fer:.4g} at 2.0 dB outside "
          f"the fixture's Wilson interval [{lo:.4g}, {hi:.4g}]")
    say(3, f"cli.sim judged minsum50 [{impl}] @ 2.0 dB: FER "
        f"{r.fer:.4g} ({r.frame_errors}/{r.frames}) in fixture Wilson "
        f"[{lo:.4g}, {hi:.4g}]; counters {got} "
        f"{'==' if got == want else '!='} fixture {want}")

    llr, u = noisy_llrs(code, 256, 2.5, seed=4)
    bits, ok, iu = map(np.asarray, api.decode(code, jnp.asarray(llr)))
    check(bits.shape == (256, code.n) and ok.mean() > 0.9,
          "decode.api.decode failed at 2.5 dB")
    say(3, f"decode.api.decode [{impl}]: {int(ok.sum())}/256 ok, mean "
        f"iters {iu.mean():.2f}")

    rec = cli_bench.main(["--family", "judged", "--impl", "twophase",
                          "--batch", str(BATCH), "--reps", "10", "--json"])
    check(math.isfinite(rec["gbps"]) and rec["gbps"] > 0,
          f"cli.bench twophase gave {rec['gbps']}")
    say(3, f"cli.bench --impl twophase flooding [{rec['impl']}]: "
        f"{rec['gbps']:.4f} Gb/s ({rec['gpu']})")


def phase4(cs, compiled, gpu: str) -> dict:
    import jax.numpy as jnp

    from tpu_ldpc import backend
    from tpu_ldpc.sim.mc import DecodeCfg

    code = cs["judged"]
    x = jnp.asarray(noisy_llrs(code, BATCH, 2.0, seed=5)[0])
    table = {}
    for label, key, cfg in (
            ("minsum flooding50 noET", "flooding50-noET", DecodeCfg()),
            ("minsum layered25 ET", "layered25",
             DecodeCfg(iters=25, schedule="layered"))):
        row = {}
        for impl, name in (("xla", "jnp"), ("kernel", "pallas")):
            sec = median_seconds(compiled["judged", key, name], x)
            row[impl] = BATCH * code.k / sec / 1e9
        auto = backend.choose_decoder(code, cfg).impl
        say(4, f"judged {label} batch {BATCH}: kernel "
            f"{row['kernel']:.4f} Gb/s, XLA {row['xla']:.4f} Gb/s "
            f"(impl=auto -> {auto}) on {gpu}")
        table[label] = row
    return table


def phase5() -> None:
    """Data-parallel Monte-Carlo across 4 cards (dist/mesh.py): the
    psum'd counters equal the sum of a one-card replay of the same
    per-device PRNG streams."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpu_ldpc.dist.mesh import (build_sharded_mc_step,
                                    fold_key_device, make_mesh)
    from tpu_ldpc.sim.mc import DecodeCfg, build_batch_fn

    code = codes()["judged"]
    cfg = DecodeCfg(iters=50)
    mesh = make_mesh(jax.devices()[:4])
    step = build_sharded_mc_step(code, cfg, BATCH, mesh)
    args = [jnp.asarray([v], dt) for v, dt in ((3, jnp.int32),
                                               (2, jnp.int32),
                                               (2.0, jnp.float32),
                                               (5, jnp.int32))]
    t0 = time.perf_counter()
    counters = np.asarray(jax.device_get(step(*args)))
    t_mesh = time.perf_counter() - t0
    one = jax.jit(build_batch_fn(code, cfg, BATCH))
    replay = sum(np.asarray(jax.device_get(one(
        fold_key_device(3, 2, 5, d), jnp.float32(2.0))))
        for d in range(4))
    check(np.array_equal(counters, replay),
          f"4-card psum {counters.tolist()} != one-card replay "
          f"{replay.tolist()}")
    say(5, f"4-card data-parallel MC step (psum over NCCL): counters "
        f"{counters.tolist()} == one-card replay of the 4 device streams "
        f"(first call incl. compile {t_mesh:.1f} s)")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the 4-card data-parallel MC path")
    args = p.parse_args(argv)
    dev = phase0(args.four_cards)
    if args.four_cards:
        phase5()
    else:
        import tempfile
        from concurrent.futures import ThreadPoolExecutor

        from tpu_ldpc import backend

        cs = codes()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(4) as golden_pool, \
                ThreadPoolExecutor(8) as compile_pool:
            golden = submit_golden(golden_pool, cs)
            compiled = phase1(cs, compile_pool)
            phase2(cs, compiled, golden)
        say(2, f"phases 1-2 took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            phase3(cs, tmp)
        phase4(cs, compiled, backend.gpu_name_and_power_limit())
        say(4, f"phases 3-4 took {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": dev}), flush=True)


if __name__ == "__main__":
    main()
