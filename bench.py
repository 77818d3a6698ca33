#!/usr/bin/env python
"""Throughput benchmark on one GPU: one JSON line on stdout.

Metric: decoded info bits/s on one card — normalized min-sum (alpha
0.75), 50 flooding iterations with early termination off, the judged
rate-1/2 (1024, 512) QC-LDPC code, batch 4096, at 2.0 dB.  Supplementary
operating points go to stderr as one JSON line.  Every record names the
device, as JAX reports it, and the card's name and power limit.

The decoder of each measurement is the backend policy's choice
(tpu_ldpc/backend.py, through cli/bench.py's build_bench_decoder); the
estimator is tpu_ldpc/benchcore.py.  Without
a GPU the script exits non-zero: it never times the CPU.

    python bench.py
"""

import json
import sys

BATCH = 4096
ITERS = 50
EBN0_DB = 2.0  # FER ~1e-2 operating point of the judged code


def measure(code, timer, dec) -> float:
    """Median seconds per batch of `dec` (benchcore's paired deltas)."""
    return timer.measure(dec, reps=5)["median_s"]


def run() -> tuple[dict, dict]:
    """(headline record, supplementary record)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpu_ldpc import backend
    from tpu_ldpc.benchcore import make_timer
    from tpu_ldpc.cli.bench import build_bench_decoder
    from tpu_ldpc.codes import LdpcCode

    code = LdpcCode.judged()
    timer, u = make_timer(code, BATCH, ebn0_db=EBN0_DB, inner=20)
    device = backend.device_summary()
    gpu = backend.gpu_name_and_power_limit()

    def gbps(seconds):
        return BATCH * code.k / seconds / 1e9

    impl, full50 = build_bench_decoder(code, iters=ITERS, early_stop=False)
    dt = measure(code, timer, full50)
    head = {
        "metric": "minsum50_decoded_info_bits_per_s",
        "value": BATCH * code.k / dt,
        "unit": "bits/s",
        "impl": impl,
        "device": device,
        "gpu": gpu,
    }
    # correctness at the operating point: one real-noise decode
    llr = timer.scale * (timer.xj + timer.sig * jax.random.normal(
        jax.random.key(0), timer.xj.shape, jnp.float32))
    bits = np.asarray(full50(llr)[0])
    extras = {
        "fer_at_2dB_full50": float((bits[:, : code.k] != u).any(1).mean()),
        "batch": BATCH,
        "ms_per_batch_full50": dt * 1e3,
        "device": device,
        "gpu": gpu,
    }
    for key, kw in (
        ("layered25_et_2dB", dict(early_stop=True, schedule="layered",
                                  iters=25)),
        ("minsum50_et_2dB", dict(early_stop=True)),
        ("sumproduct50_et_2dB", dict(early_stop=True, algo="sumproduct")),
        ("layered25_twophase_2dB", dict(early_stop=True, schedule="layered",
                                        iters=25, impl="twophase")),
    ):
        impl, dec = build_bench_decoder(code, **{"iters": ITERS, **kw})
        extras[key + "_gbps"] = gbps(measure(code, timer, dec))
        extras[key + "_impl"] = impl
    return head, extras


def main() -> None:
    from tpu_ldpc import backend

    backend.require_gpu("bench.py")
    backend.use_compile_cache()
    head, extras = run()
    print(json.dumps(extras), file=sys.stderr)
    print(json.dumps(head), flush=True)


if __name__ == "__main__":
    main()
