"""Golden NumPy belief-propagation decoders.

This module is the ground truth for the whole framework (SURVEY.md C16):
an explicit, trustworthy implementation of sum-product and
normalized/offset min-sum decoding with true sequential early-termination
semantics.  Every device decoder (jnp reference, Pallas kernels) is tested
against it — for min-sum with ``dtype=np.float32`` the comparison is
*bit-exact* because the arithmetic contract below is followed by every
implementation:

Arithmetic contract (shared by golden / jnp / Pallas decoders):
  * VN posterior:  P[j] = L[j] + sum of incident CN->VN messages R,
    accumulated sequentially in **increasing row order** (for a QC code
    this equals increasing block-row order).
  * VN->CN message: Q[i,j] = P[j] - R[i,j]   (subtract-extrinsic form).
  * Min-sum CN update: sequential two-min scan in edge order (ties keep
    the first-occurrence argmin) + sign product over the row, then
    R_new = alpha * max(min_excl - beta, 0) * (total_sign * sign_e).
    min/compare/multiply are exact in fp32 given identical inputs.
  * Hard decision: bit = 1 iff P < 0  (ties decode to 0).
  * Early termination: syndrome H@hard(P) checked on the channel LLRs
    (iteration 0) and after every full iteration; a converged codeword's
    messages and posterior freeze; iters_used records the first iteration
    index at which the syndrome was zero (0 if the raw channel decision
    already satisfies H, ``iters`` if never).

The implementation pads rows/columns to uniform degree and runs the CN
two-min scan and VN accumulation as vectorized *slot* loops — the slot
order equals edge order, so the sequential-order contract is preserved
exactly while staying fast enough to pair-test full-size codes.

Sum-product uses the stable sign/log-magnitude form with the same
clipping constants as the device decoders (compare with fp tolerance,
not bit-exactness).
"""

from __future__ import annotations



import numpy as np
import scipy.sparse as sp

# Sum-product stability clips, shared verbatim with the device decoders.
SP_MIN_MAG = 1e-9     # lower clip on |Q| before phi()
SP_MAX_MAG = 30.0     # upper clip on |Q|; tanh(15) saturates fp32 anyway


def _phi(x: np.ndarray) -> np.ndarray:
    """phi(x) = -log(tanh(x/2)), self-inverse on (0, inf)."""
    x = np.clip(x, SP_MIN_MAG, SP_MAX_MAG)
    return -np.log(np.tanh(x / 2.0))


# ---------------------------------------------------------------------------
# Fixed-point quantization contract (hardware-emulation decode mode)
#
# Q_{b,s}(x) = sign(x) * min(floor(|x|/s + 0.5), 2^(b-1)-1) * s
#
# i.e. round-half-away-from-zero to the LSB grid `s`, symmetric saturation
# at +/- (2^(b-1)-1)*s (no negative full scale — the sign-magnitude form
# every hardware min-sum decoder uses).  Every operation (abs, divide by a
# float, +0.5, floor, min, two multiplies, in THIS order) is a single
# correctly-rounded fp32 op, so the golden / jnp / Pallas implementations
# agree bit-exactly.  Where it is applied (the standard fixed-point
# datapath model):
#   1. channel LLRs on entry:           L  = Q_{b,s}(llr)
#   2. VN->CN messages (saturation):    q  = sat_{b,s}(P - R)
#   3. CN outputs (after alpha/beta):   R  = Q_{b,s}(cn_update(q))
#   4. posterior (wider accumulator):   P  = sat_{bp,s}(L + sum R),
#      bp = quant_post_bits (default b+2, the usual APP width).
# Grid-valued sums/differences are exact in fp32 (integers * s with
# |k| << 2^24), so 2. and 4. reduce to pure saturating clips.  In the
# layered schedule, 2. applies to the CN input only — the in-place
# posterior update uses the UNSATURATED difference (the wide-APP
# datapath); clamping the posterior through the message range every row
# sweep destroys it (measured: 2/128 vs 119/128 frames at 4 bits).
# Q returns +0.0 (never -0.0) when the value rounds to zero.
# Only algo='minsum' supports quantization (sum-product is table-domain
# in hardware, a different datapath).
# ---------------------------------------------------------------------------


def quantize(x: np.ndarray, bits: int, step: float, dtype=np.float32):
    """Q_{bits,step}(x) per the contract above (round + saturate).

    step must be a power of two: |x|/step is then an exact fp32
    exponent shift, so every backend (NumPy / XLA, which may lower
    division via reciprocal approximation) rounds the +0.5
    identically.  Mirrors decode.reference.make_quantizers.
    """
    import math

    if not (step > 0 and math.frexp(float(step))[0] == 0.5):
        raise ValueError(f"quant step must be a power of two (got {step})")
    dtype = np.dtype(dtype).type
    x = np.asarray(x, dtype=dtype)
    m = dtype((1 << (bits - 1)) - 1)
    k = np.floor(np.abs(x) / dtype(step) + dtype(0.5))
    k = np.minimum(k, m)
    # canonicalize k==0 to +0.0: sign(x)*0 would yield -0.0 for x<0, and
    # the Pallas kernel reads sign BITS (golden reads `< 0`) — a negative
    # zero would silently break the cross-implementation contract.
    return np.where(k == 0, dtype(0.0), (np.sign(x) * k) * dtype(step))


def saturate(x: np.ndarray, bits: int, step: float, dtype=np.float32):
    """Pure saturating clip to +/- (2^(bits-1)-1)*step (grid-valued input)."""
    dtype = np.dtype(dtype).type
    lim = dtype(dtype((1 << (bits - 1)) - 1) * dtype(step))
    return np.clip(np.asarray(x, dtype=dtype), -lim, lim)


class _Graph:
    """Padded slot structure of H's Tanner graph, edges sorted by (row, col)."""

    def __init__(self, H):
        Hc = sp.coo_matrix(H)
        order = np.lexsort((Hc.col, Hc.row))
        self.rows = Hc.row[order].astype(np.int64)
        self.cols = Hc.col[order].astype(np.int64)
        self.m, self.n = Hc.shape
        self.E = len(self.rows)
        self.row_slots, self.row_mask = _pad_slots(self.rows, self.m, self.E)
        self.col_slots, self.col_mask = _pad_slots(self.cols, self.n, self.E)


def _pad_slots(owner: np.ndarray, count: int, E: int):
    """owner: (E,) sorted group ids -> (count, max_deg) edge-index table."""
    deg = np.bincount(owner, minlength=count)
    max_deg = int(deg.max()) if E else 0
    slots = np.zeros((count, max_deg), dtype=np.int64)
    mask = np.zeros((count, max_deg), dtype=bool)
    # edge indices grouped by owner, in edge order (owner is sorted for rows;
    # for cols we need ascending row order per col — achieved by stable argsort)
    idx = np.argsort(owner, kind="stable")
    pos = np.zeros(count, dtype=np.int64)
    for e in idx:
        o = owner[e]
        slots[o, pos[o]] = e
        mask[o, pos[o]] = True
        pos[o] += 1
    return slots, mask


def syndrome_ok(H, bits: np.ndarray) -> np.ndarray:
    """H @ bits^T == 0 per codeword. bits: (batch, n) in {0,1}."""
    Hcsr = sp.csr_matrix(H).astype(np.int64)
    syn = np.asarray((Hcsr @ bits.T) % 2)
    return ~np.any(syn, axis=0)


# ---------------------------------------------------------------------------
# sumproduct-fast: the lambda-min2 approximation of the sum-product CN
# update, built ONLY from exact fp32 ops (min/max/add/mul) so the golden
# == jnp == Pallas bit-exact contract extends to it (exact SP's
# tanh/log transcendentals can never be bit-pinned across backends).
#
# Contract (fp32 ops in EXACTLY this order in every implementation):
#   ctilde(x) = max(max(max(0.6931472 - 0.5*x, 0.57 - 0.25*x),
#                       0.40 - 0.125*x), 0)
#                                      # 3-segment PWL of log(1+e^-x)
#                                      # (max |err| < 0.032);
#                                      # slopes are powers of two so the
#                                      # products are exact and XLA's
#                                      # FMA fusion cannot change the
#                                      # rounding vs NumPy's mul-then-sub
#   f(a, b)   = max(min(a, b) + (ctilde(a+b) - ctilde(|a-b|)), 0)
#                                      # PWL pairwise soft-min (min*)
# Per row: three-smallest scan (m1<=m2<=m3 with first-occurrence slot
# argmins a1, a2; strict < comparisons, same tie semantics as the
# two-min scan); output magnitude per edge slot t:
#   deg 1: m1 (own magnitude — min-sum convention)
#   deg 2: t==a1 -> m2 else m1 (exact: phi(phi(x)) == x)
#   deg>=3: t==a1 -> f(m2,m3); t==a2 -> f(m1,m3); else -> f(m1,m2)
# Signs as min-sum (XOR product); alpha/beta ignored (like sumproduct).
# ---------------------------------------------------------------------------


def _ctilde(x, dtype):
    return np.maximum(
        np.maximum(
            np.maximum(dtype(0.6931472) - dtype(0.5) * x,
                       dtype(0.57) - dtype(0.25) * x),
            dtype(0.40) - dtype(0.125) * x,
        ),
        dtype(0.0),
    )


def _fpair(a, b, dtype):
    d1 = _ctilde(a + b, dtype)
    d2 = _ctilde(np.abs(a - b), dtype)
    return np.maximum(np.minimum(a, b) + (d1 - d2), dtype(0.0))


def _cn_pass(Q: np.ndarray, g: _Graph, algo: str, alpha, beta, dtype, quant=None):
    """Vectorized CN update for all rows. Q: (E,) -> R_new: (E,)."""
    mag = np.abs(Q)
    sign = np.where(Q < 0, dtype(-1.0), dtype(1.0))
    slot_mag = np.where(g.row_mask, mag[g.row_slots], np.inf).astype(dtype)
    slot_sign = np.where(g.row_mask, sign[g.row_slots], dtype(1.0))
    max_deg = g.row_slots.shape[1]
    if algo == "minsum":
        # sequential two-min scan over slots == edge order per row
        min1 = slot_mag[:, 0].copy()
        min2 = np.full(g.m, np.inf, dtype=dtype)
        argmin = np.zeros(g.m, dtype=np.int64)
        for t in range(1, max_deg):
            mt = slot_mag[:, t]
            new = mt < min1
            min2 = np.where(new, min1, np.minimum(min2, mt))
            argmin = np.where(new, t, argmin)
            min1 = np.where(new, mt, min1)
        # degree-1 rows: golden semantics sends own magnitude
        deg1 = ~g.row_mask[:, 1] if max_deg > 1 else np.ones(g.m, dtype=bool)
        min2 = np.where(deg1, min1, min2)
        total_sign = np.prod(slot_sign, axis=1)
        slot_t = np.arange(max_deg)[None, :]
        mag_excl = np.where(slot_t == argmin[:, None], min2[:, None], min1[:, None])
        mag_excl = np.maximum(mag_excl - dtype(beta), dtype(0.0))
        out = (total_sign[:, None] * slot_sign) * (dtype(alpha) * mag_excl)
    elif algo == "sumproduct-fast":
        # three-smallest scan, first-occurrence argmins (strict <)
        inf = dtype(np.inf)
        m1 = slot_mag[:, 0].copy()
        m2 = np.full(g.m, inf, dtype=dtype)
        m3 = np.full(g.m, inf, dtype=dtype)
        a1 = np.zeros(g.m, dtype=np.int64)
        a2 = np.full(g.m, -1, dtype=np.int64)
        for t in range(1, max_deg):
            mt = slot_mag[:, t]
            lt1 = mt < m1
            lt2 = ~lt1 & (mt < m2)
            lt3 = ~lt1 & ~lt2 & (mt < m3)
            m3 = np.where(lt1 | lt2, m2, np.where(lt3, mt, m3))
            m2 = np.where(lt1, m1, np.where(lt2, mt, m2))
            a2 = np.where(lt1, a1, np.where(lt2, t, a2))
            m1 = np.where(lt1, mt, m1)
            a1 = np.where(lt1, t, a1)
        deg = g.row_mask.sum(axis=1)
        f23 = _fpair(m2, m3, dtype)
        f13 = _fpair(m1, m3, dtype)
        f12 = _fpair(m1, m2, dtype)
        slot_t = np.arange(max_deg)[None, :]
        mag_out = np.where(
            slot_t == a1[:, None], f23[:, None],
            np.where(slot_t == a2[:, None], f13[:, None], f12[:, None]),
        )
        # low-degree exact cases
        mag_out = np.where(
            (deg == 2)[:, None],
            np.where(slot_t == a1[:, None], m2[:, None], m1[:, None]),
            mag_out,
        )
        mag_out = np.where((deg == 1)[:, None], m1[:, None], mag_out)
        total_sign = np.prod(slot_sign, axis=1)
        out = (total_sign[:, None] * slot_sign) * mag_out
    else:  # sumproduct
        ph = np.where(g.row_mask, _phi(slot_mag.astype(np.float64)), 0.0)
        tot = np.sum(ph, axis=1, keepdims=True)
        total_sign = np.prod(slot_sign, axis=1)
        out = (total_sign[:, None] * slot_sign) * _phi(tot - ph).astype(dtype)
    if quant is not None:
        out = quantize(out, quant[0], quant[1], dtype)
    R_new = np.empty(g.E, dtype=dtype)
    R_new[g.row_slots[g.row_mask]] = out[g.row_mask]
    return R_new


def _vn_pass(L: np.ndarray, R: np.ndarray, g: _Graph, dtype):
    """P[j] = L[j] + sum_t R[slot_t]; sequential over slots (asc. row order)."""
    P = L.copy()
    for t in range(g.col_slots.shape[1]):
        valid = g.col_mask[:, t]
        P[valid] = P[valid] + R[g.col_slots[valid, t]]
    return P


def decode(
    H,
    llr: np.ndarray,
    algo: str = "minsum",
    iters: int = 50,
    alpha: float = 0.75,
    beta: float = 0.0,
    schedule: str = "flooding",
    dtype=np.float64,
    early_stop: bool = True,
    quant_bits: int | None = None,
    quant_step: float = 0.5,
    quant_post_bits: int | None = None,
):
    """Decode a batch of LLR vectors with the golden BP decoder.

    Args:
      H: (m, n) parity-check matrix (scipy sparse or dense 0/1).
      llr: (batch, n) channel LLRs, positive means bit 0 more likely.
      algo: 'minsum' (normalized/offset), 'sumproduct', or
        'sumproduct-fast' (lambda-min2 PWL approximation of SP — see the
        contract block above _ctilde; exact fp32 ops, so bit-exact
        against the jnp/Pallas implementations like min-sum).
      iters: max iterations.
      alpha, beta: min-sum normalization / offset (alpha=1, beta=0 => plain).
      schedule: 'flooding' or 'layered' (row-layered, rows ascending).
      dtype: working precision (float64 default; float32 for bit-exact
        comparison against device kernels).
      early_stop: freeze converged codewords (sequential semantics).
      quant_bits / quant_step / quant_post_bits: fixed-point emulation
        mode (min-sum only) — see the module-level quantization contract.
        None (default) = full floating point.

    Returns:
      bits: (batch, n) uint8 hard decisions.
      ok: (batch,) bool, syndrome satisfied.
      iters_used: (batch,) int32 per the module-docstring contract.
    """
    if schedule not in ("flooding", "layered"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if algo not in ("minsum", "sumproduct", "sumproduct-fast"):
        raise ValueError(f"unknown algo {algo!r}")
    quant = None
    if quant_bits is not None:
        if algo != "minsum":
            raise ValueError("quantized decoding supports algo='minsum' only")
        quant = (int(quant_bits), float(quant_step))
        post = (int(quant_post_bits) if quant_post_bits is not None
                else int(quant_bits) + 2, float(quant_step))
    dtype = np.dtype(dtype).type
    llr = np.asarray(llr, dtype=dtype)
    if llr.ndim == 1:
        llr = llr[None, :]
    batch, n = llr.shape
    g = _Graph(H)
    assert g.n == n, (g.n, n)
    Hcsr = sp.csr_matrix(H).astype(np.int64)

    bits_out = np.zeros((batch, n), dtype=np.uint8)
    ok_out = np.zeros(batch, dtype=bool)
    iters_out = np.full(batch, iters, dtype=np.int32)

    if quant is not None:
        llr = quantize(llr, quant[0], quant[1], dtype)

    for b in range(batch):
        L = llr[b]
        R = np.zeros(g.E, dtype=dtype)
        P = L.copy()

        def hard(p):
            return (p < 0).astype(np.uint8)

        def syn_ok(p):
            return not (np.asarray(Hcsr @ hard(p)) % 2).any()

        if early_stop and syn_ok(P):
            bits_out[b], ok_out[b], iters_out[b] = hard(P), True, 0
            continue

        converged = False
        for it in range(1, iters + 1):
            if schedule == "flooding":
                Q = P[g.cols] - R
                if quant is not None:
                    Q = saturate(Q, quant[0], quant[1], dtype)
                R = _cn_pass(Q, g, algo, alpha, beta, dtype, quant)
                P = _vn_pass(L, R, g, dtype)
                if quant is not None:
                    P = saturate(P, post[0], post[1], dtype)
            else:  # layered: rows sequentially, posterior updated in place
                for i in range(g.m):
                    e = g.row_slots[i][g.row_mask[i]]
                    q_raw = P[g.cols[e]] - R[e]
                    # saturation applies to the CN *input* only; the
                    # posterior keeps the wide APP value (q_raw), else the
                    # message range clamps the posterior every row sweep
                    q = (saturate(q_raw, quant[0], quant[1], dtype)
                         if quant is not None else q_raw)
                    r_new = _cn_update_row(q, algo, alpha, beta, dtype, quant)
                    p_new = q_raw + r_new
                    if quant is not None:
                        p_new = saturate(p_new, post[0], post[1], dtype)
                    P[g.cols[e]] = p_new
                    R[e] = r_new
            if early_stop and syn_ok(P):
                bits_out[b], ok_out[b], iters_out[b] = hard(P), True, it
                converged = True
                break
        if not converged:
            bits_out[b] = hard(P)
            iters_out[b] = iters
            ok_out[b] = syn_ok(P) if not early_stop else False
    return bits_out, ok_out, iters_out


def _cn_update_row(q: np.ndarray, algo: str, alpha, beta, dtype,
                   quant=None) -> np.ndarray:
    """Extrinsic CN->VN messages for one check row (layered path). q: (deg,)."""
    sign = np.where(q < 0, dtype(-1.0), dtype(1.0))
    mag = np.abs(q)
    total_sign = np.prod(sign)
    if algo == "minsum":
        order = np.argsort(mag, kind="stable")
        min1_idx = order[0]
        min1 = mag[min1_idx]
        min2 = mag[order[1]] if len(mag) > 1 else min1
        mag_excl = np.where(np.arange(len(mag)) == min1_idx, min2, min1)
        mag_excl = np.maximum(mag_excl - dtype(beta), dtype(0.0))
        out = dtype(alpha) * mag_excl
    elif algo == "sumproduct-fast":
        d = len(mag)
        if d == 1:
            out = mag.copy()
        else:
            order = np.argsort(mag, kind="stable")
            i1, i2 = order[0], order[1]
            m1, m2 = mag[i1], mag[i2]
            idx = np.arange(d)
            if d == 2:
                out = np.where(idx == i1, m2, m1)
            else:
                m3 = mag[order[2]]
                out = np.where(
                    idx == i1, _fpair(m2, m3, dtype),
                    np.where(idx == i2, _fpair(m1, m3, dtype),
                             _fpair(m1, m2, dtype)),
                )
    else:
        ph = _phi(mag.astype(np.float64)).astype(dtype)
        tot = np.sum(ph)
        out = _phi((tot - ph).astype(np.float64)).astype(dtype)
    out = (total_sign * sign) * out
    if quant is not None:
        out = quantize(out, quant[0], quant[1], dtype)
    return out
