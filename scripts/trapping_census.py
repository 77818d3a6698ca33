"""Trapping-set census of the nr2_r15_z64 floor regime (VERDICT r4 #4).

Measures, rather than asserts, the mechanism behind the rate-1/5
slope shallowing past 1.2 dB (the nr2 waterfall): harvest
failed frames at the punctured operating condition over 1.2-1.6 dB,
classify residual-error supports into (a, b) classes
(codes/trapping.py), and report the dominant classes, their
distinct-support multiplicities, and any codeword-support (b=0)
undetected errors cross-referenced against the d_min <= 43
certificate.

Writes artifacts/nr2_trapping_census.json (atomic).

Run (a GPU strongly preferred: the decoder the backend policy picks
there harvests far faster than the native CPU decoder at this n; on a
CPU backend the native decoder harvests):
    timeout 3600 python scripts/trapping_census.py
"""

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

OUT = os.path.join(REPO, "artifacts", "nr2_trapping_census.json")

# operating points: the floor regime
# (punctured-channel FER 3.3e-3 / 1.7e-3 / 6.3e-4)
POINTS = [(1.2, 150), (1.4, 120), (1.6, 80)]  # (Eb/N0 dB, target info-wrong)
ITERS = 50
ALPHA = 0.75
CHUNK = 2048
MAX_FRAMES = 1 << 19  # 524k frames/point cap


def main():
    import jax
    import jax.numpy as jnp

    from tpu_ldpc.codes.nrlike import nrlike_code
    from tpu_ldpc.codes.trapping import census, harvest_failures

    from tpu_ldpc import backend
    from tpu_ldpc.decode.api import build_decode_fn
    from tpu_ldpc.sim.mc import DecodeCfg

    backend.use_compile_cache()
    code = nrlike_code("1/5", 64, bg=2)
    decode = None
    if backend.on_gpu():
        dec = build_decode_fn(code, DecodeCfg(algo="minsum", iters=ITERS,
                                              alpha=ALPHA))

        def decode(llr):
            return [np.asarray(a) for a in jax.block_until_ready(
                dec(jnp.asarray(llr)))]

    res = {"date": time.strftime("%Y-%m-%d %H:%M"), "cell": code.name,
           "n": code.n, "k": code.k, "channel": "punctured (first 2Z)",
           "iters": ITERS, "alpha": ALPHA,
           "backend": backend.platform(), "points": []}
    for ebn0, target in POINTS:
        t0 = time.time()
        last = [0]

        def progress(frames, nfail, _last=last, _t0=t0):
            if frames - _last[0] >= 16 * CHUNK:
                _last[0] = frames
                print(f"  {frames} frames, {nfail} failures, "
                      f"{time.time() - _t0:.0f}s", flush=True)

        fails, frames = harvest_failures(
            code, ebn0, iters=ITERS, alpha=ALPHA, target=target,
            max_frames=MAX_FRAMES, chunk=CHUNK, n_punct=2 * code.Z,
            decode=decode, target_info_wrong=True, progress=progress)
        info_fails = [f for f in fails if f.info_wrong > 0]
        parity_only = [f for f in fails if f.info_wrong == 0]
        point = {
            "ebn0_db": ebn0, "frames": frames,
            "n_failed_frames": len(fails),
            "fer_info": len(info_fails) / frames,
            "detected_rate": len(fails) / frames,
            "census_info_wrong": census(info_fails),
            "census_parity_only": census(parity_only, top=6),
            "wall_s": round(time.time() - t0, 1),
        }
        res["points"].append(point)
        tmp = OUT + ".tmp"
        with open(tmp, "w") as f:
            json.dump(res, f, indent=1)
        os.replace(tmp, OUT)
        ci = point["census_info_wrong"]
        print(f"{ebn0} dB: {frames} frames, info-FER "
              f"{point['fer_info']:.3e}, top classes "
              f"{[(c['a'], c['b'], c['count']) for c in ci['classes'][:5]]}, "
              f"undetected {ci['undetected']}", flush=True)
    print("DONE", flush=True)


if __name__ == "__main__":
    main()
