"""Pure-jnp reference BP decoders (SURVEY.md M1): correctness before speed.

XLA-compiled (CPU or GPU), no Pallas.  Follows the golden arithmetic
contract (tpu_ldpc/golden/decoder.py docstring) exactly, so min-sum in
float32 is bit-exact against the golden model given identical LLRs:

  * per-edge CN->VN messages R kept in *check coordinates*: R[e][r] is
    the message from check r of block-row bi[e] to variable
    (r + shift[e]) % Z of block-col bj[e];
  * circulant gathers are jnp.roll along the Z axis (variable->check:
    roll(v, -s); check->variable: roll(r, +s));
  * two-min via a sequential scan in edge order (first-occurrence
    argmin), VN sums accumulated sequentially in ascending block-row
    order.

Array shapes: LLR (batch, n) -> internal (batch, nb, Z); R (batch, E, Z).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from tpu_ldpc.codes.code import LdpcCode
from tpu_ldpc.golden.decoder import SP_MAX_MAG, SP_MIN_MAG


def _block_structure(code: LdpcCode):
    """Static (trace-time) protograph structure, edges sorted by (row, col)."""
    B = code.B
    mb, nb = B.shape
    edges = [(i, j, int(B[i, j])) for i in range(mb) for j in range(nb) if B[i, j] >= 0]
    row_edges = [[e for e, (i, _, _) in enumerate(edges) if i == r] for r in range(mb)]
    col_edges = [[e for e, (_, j, _) in enumerate(edges) if j == c] for c in range(nb)]
    return edges, row_edges, col_edges


def _phi_jnp(x):
    x = jnp.clip(x, SP_MIN_MAG, SP_MAX_MAG)
    return -jnp.log(jnp.tanh(x * 0.5))


def make_quantizers(bits: int, step: float, post_bits: int):
    """(quantize, sat_msg, sat_post) jnp closures matching the golden
    fixed-point contract (tpu_ldpc/golden/decoder.py) bit-exactly: the
    same fp32 op sequence (abs, /step, +0.5, floor, min, sign*k*step),
    with the saturation limits precomputed in fp32 on the host exactly
    as golden's `saturate` computes them.

    step MUST be a power of two: |x|/step is then an exact exponent
    shift in fp32, so NumPy and XLA on every backend (which may lower
    f32 division via reciprocal approximation) all round identically.  Enforced here and in golden.quantize.
    """
    m = float((1 << (bits - 1)) - 1)
    step = float(step)
    import math

    if not (step > 0 and math.frexp(step)[0] == 0.5):
        raise ValueError(
            f"quant_step must be a power of two (got {step}): non-pow2 "
            "steps make |x|/step rounding backend-dependent and break "
            "the golden==jnp bit-exact contract on real devices"
        )

    def quantize(x):
        k = jnp.minimum(jnp.floor(jnp.abs(x) / step + 0.5), m)
        # k==0 -> +0.0 (never -0.0): the Pallas kernel reads sign bits
        return jnp.where(k == 0, 0.0, (jnp.sign(x) * k) * step)

    def _sat(lim):
        lim = float(np.float32(np.float32(lim) * np.float32(step)))
        return lambda x: jnp.clip(x, -lim, lim)

    return (quantize, _sat((1 << (bits - 1)) - 1),
            _sat((1 << (post_bits - 1)) - 1))


def _cn_minsum(qs, alpha, beta):
    """Two-min CN update matching the golden scan semantics.

    qs: list of (batch, Z) VN->CN messages for one block-row.
    Returns list of (batch, Z) CN->VN messages.
    """
    d = len(qs)
    mags = [jnp.abs(q) for q in qs]
    sgns = [jnp.where(q < 0, -1.0, 1.0).astype(q.dtype) for q in qs]
    big = jnp.full_like(mags[0], jnp.inf)
    min1, min2 = mags[0], big
    argmin = jnp.zeros_like(mags[0], dtype=jnp.int32)
    for e in range(1, d):
        m = mags[e]
        is_new_min = m < min1
        min2 = jnp.where(is_new_min, min1, jnp.minimum(min2, m))
        argmin = jnp.where(is_new_min, e, argmin)
        min1 = jnp.where(is_new_min, m, min1)
    total_sign = sgns[0]
    for e in range(1, d):
        total_sign = total_sign * sgns[e]
    if d == 1:
        min2 = min1  # golden: single-edge row sends its own magnitude
    outs = []
    for e in range(d):
        mag_excl = jnp.where(argmin == e, min2, min1)
        mag_excl = jnp.maximum(mag_excl - beta, 0.0)
        outs.append((total_sign * sgns[e]) * (alpha * mag_excl))
    return outs


def _ctilde_jnp(x):
    """3-segment PWL of log(1+e^-x) (max |err| < 0.032); FMA-safe: both slopes are powers of
    two so the products are exact and fused/unfused lowering round
    identically (the bit-exact contract in golden/decoder.py)."""
    return jnp.maximum(
        jnp.maximum(
            jnp.maximum(0.6931472 - 0.5 * x, 0.57 - 0.25 * x),
            0.40 - 0.125 * x,
        ),
        0.0,
    )


def _fpair_jnp(a, b):
    d1 = _ctilde_jnp(a + b)
    d2 = _ctilde_jnp(jnp.abs(a - b))
    return jnp.maximum(jnp.minimum(a, b) + (d1 - d2), 0.0)


def _cn_sumproduct_fast(qs):
    """lambda-min2 PWL sum-product CN update; golden contract in
    tpu_ldpc/golden/decoder.py (block above _ctilde)."""
    d = len(qs)
    mags = [jnp.abs(q) for q in qs]
    sgns = [jnp.where(q < 0, -1.0, 1.0).astype(q.dtype) for q in qs]
    total_sign = sgns[0]
    for e in range(1, d):
        total_sign = total_sign * sgns[e]
    if d == 1:
        outs_mag = [mags[0]]
    elif d == 2:
        outs_mag = [mags[1], mags[0]]
    else:
        big = jnp.full_like(mags[0], jnp.inf)
        m1, m2, m3 = mags[0], big, big
        a1 = jnp.zeros_like(mags[0], dtype=jnp.int32)
        a2 = jnp.full_like(a1, -1)
        for t in range(1, d):
            mt = mags[t]
            lt1 = mt < m1
            lt2 = ~lt1 & (mt < m2)
            lt3 = ~lt1 & ~lt2 & (mt < m3)
            m3 = jnp.where(lt1 | lt2, m2, jnp.where(lt3, mt, m3))
            m2 = jnp.where(lt1, m1, jnp.where(lt2, mt, m2))
            a2 = jnp.where(lt1, a1, jnp.where(lt2, t, a2))
            m1 = jnp.where(lt1, mt, m1)
            a1 = jnp.where(lt1, t, a1)
        f23 = _fpair_jnp(m2, m3)
        f13 = _fpair_jnp(m1, m3)
        f12 = _fpair_jnp(m1, m2)
        outs_mag = [
            jnp.where(a1 == t, f23, jnp.where(a2 == t, f13, f12))
            for t in range(d)
        ]
    return [(total_sign * sgns[e]) * outs_mag[e] for e in range(d)]


def _cn_sumproduct(qs):
    d = len(qs)
    mags = [jnp.abs(q) for q in qs]
    sgns = [jnp.where(q < 0, -1.0, 1.0).astype(q.dtype) for q in qs]
    phis = [_phi_jnp(m) for m in mags]
    tot = phis[0]
    for e in range(1, d):
        tot = tot + phis[e]
    total_sign = sgns[0]
    for e in range(1, d):
        total_sign = total_sign * sgns[e]
    return [(total_sign * sgns[e]) * _phi_jnp(tot - phis[e]) for e in range(d)]


def _syndrome_ok(P, edges, row_edges, Z):
    """(batch,) bool: H @ hard(P) == 0, via rolled XOR over block-rows."""
    bits = (P < 0).astype(jnp.int32)  # (batch, nb, Z)
    ok = None
    for r, es in enumerate(row_edges):
        acc = None
        for e in es:
            _, j, s = edges[e]
            v = jnp.roll(bits[:, j, :], -s, axis=-1)
            acc = v if acc is None else acc + v
        row_ok = jnp.all(acc % 2 == 0, axis=-1)
        ok = row_ok if ok is None else (ok & row_ok)
    return ok


@functools.lru_cache(maxsize=64)
def build_decoder(
    code: LdpcCode,
    algo: str = "minsum",
    iters: int = 50,
    alpha: float = 0.75,
    beta: float = 0.0,
    schedule: str = "flooding",
    early_stop: bool = True,
    dtype=jnp.float32,
    quant_bits: int | None = None,
    quant_step: float = 0.5,
    quant_post_bits: int | None = None,
):
    """Build a jitted jnp decoder: llr (batch, n) -> (bits, ok, iters_used).

    quant_bits/quant_step/quant_post_bits: fixed-point hardware-emulation
    mode (min-sum only), bit-exact vs the golden quantized model — see the
    quantization contract in tpu_ldpc/golden/decoder.py.
    """
    if algo not in ("minsum", "sumproduct", "sumproduct-fast"):
        raise ValueError(f"unknown algo {algo!r}")
    if schedule not in ("flooding", "layered"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if quant_bits is not None and algo != "minsum":
        raise ValueError("quantized decoding supports algo='minsum' only")
    edges, row_edges, col_edges = _block_structure(code)
    Z, nb, mb, k = code.Z, code.nb, code.mb, code.k
    E = len(edges)
    qz = sat_msg = sat_post = None
    if quant_bits is not None:
        qz, sat_msg, sat_post = make_quantizers(
            int(quant_bits), float(quant_step),
            int(quant_post_bits) if quant_post_bits is not None
            else int(quant_bits) + 2,
        )

    def cn_update(qs):
        if algo == "minsum":
            outs = _cn_minsum(qs, alpha, beta)
            return [qz(o) for o in outs] if qz is not None else outs
        if algo == "sumproduct-fast":
            return _cn_sumproduct_fast(qs)
        return _cn_sumproduct(qs)

    def flooding_iter(L, P, R):
        # CN pass (per block-row), R in check coordinates
        R_new = [None] * E
        for i in range(mb):
            qs = []
            for e in row_edges[i]:
                _, j, s = edges[e]
                p_rot = jnp.roll(P[:, j, :], -s, axis=-1)
                q = p_rot - R[:, e, :]
                qs.append(sat_msg(q) if sat_msg is not None else q)
            for e, r_out in zip(row_edges[i], cn_update(qs)):
                R_new[e] = r_out
        R_new = jnp.stack(R_new, axis=1)
        # VN pass: sequential accumulation in ascending block-row order
        cols = []
        for j in range(nb):
            p = L[:, j, :]
            for e in col_edges[j]:
                _, _, s = edges[e]
                p = p + jnp.roll(R_new[:, e, :], s, axis=-1)
            cols.append(sat_post(p) if sat_post is not None else p)
        return jnp.stack(cols, axis=1), R_new

    def layered_iter(L, P, R):
        del L
        for i in range(mb):
            qs_raw, qs = [], []
            for e in row_edges[i]:
                _, j, s = edges[e]
                p_rot = jnp.roll(P[:, j, :], -s, axis=-1)
                q = p_rot - R[:, e, :]
                qs_raw.append(q)
                # message saturation feeds the CN only; the posterior
                # update keeps the wide APP value (golden contract)
                qs.append(sat_msg(q) if sat_msg is not None else q)
            outs = cn_update(qs)
            for e, q, r_out in zip(row_edges[i], qs_raw, outs):
                _, j, s = edges[e]
                p_new = q + r_out
                if sat_post is not None:
                    p_new = sat_post(p_new)
                P = P.at[:, j, :].set(jnp.roll(p_new, s, axis=-1))
                R = R.at[:, e, :].set(r_out)
        return P, R

    iteration = flooding_iter if schedule == "flooding" else layered_iter

    @jax.jit
    def decode_fn(llr):
        llr = llr.astype(dtype)
        if qz is not None:
            llr = qz(llr)
        batch = llr.shape[0]
        L = llr.reshape(batch, nb, Z)
        P = L
        R = jnp.zeros((batch, E, Z), dtype=dtype)
        done0 = _syndrome_ok(P, edges, row_edges, Z) if early_stop else jnp.zeros(
            batch, dtype=bool
        )
        iters_used0 = jnp.where(done0, 0, iters).astype(jnp.int32)

        def body(it, carry):
            P, R, done, iu = carry
            P_new, R_new = iteration(L, P, R)
            keep = done[:, None, None]
            P = jnp.where(keep, P, P_new)
            R = jnp.where(keep, R, R_new)
            ok_now = _syndrome_ok(P, edges, row_edges, Z)
            newly = ok_now & ~done
            iu = jnp.where(newly, it, iu)
            done = done | ok_now
            return P, R, done, iu

        if early_stop:
            P, R, done, iu = jax.lax.fori_loop(
                1, iters + 1, body, (P, R, done0, iters_used0)
            )
            ok = done
        else:
            def body_ne(it, carry):
                P, R = carry
                return iteration(L, P, R)

            P, R = jax.lax.fori_loop(1, iters + 1, body_ne, (P, R))
            ok = _syndrome_ok(P, edges, row_edges, Z)
            iu = jnp.full(batch, iters, dtype=jnp.int32)
        bits = (P < 0).reshape(batch, nb * Z).astype(jnp.uint8)
        return bits, ok, iu

    return decode_fn


def decode(code: LdpcCode, llr, **kw):
    """Convenience wrapper: decode a batch of LLRs with the jnp decoder."""
    fn = build_decoder(code, **kw)
    return fn(jnp.asarray(llr))
