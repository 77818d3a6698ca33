"""Windowed decoding for spatially-coupled (SC) LDPC chains.

The streaming decoder for SC-LDPC (SURVEY.md §5 long-context analog):
a width-W window of block-rows slides down the chain, running a few BP
iterations per slide.  Positions behind the window are committed (their
messages freeze), positions ahead are untouched.  What this buys is
BOUNDED LATENCY AND STATE: bits stream out W positions behind the
newest received position, with per-slide compute and live message
state O(W) instead of O(L) — the property that makes SC-LDPC usable on
unbounded streams.  Decode quality approaches full-chain BP from above
as W grows (measured, frozen in tests/test_windowed.py); at operating
points above the underlying ensemble's BP threshold a truncated
full-chain flooding decode can match it in FER-per-edge-work (measured
on L=32/64 chains), so choose windowed decoding for its latency/memory
contract, not as a throughput trick.

Accelerator-native formulation.  `make_sc_base_graph` chains (coupling width
w=2) are BANDED: block-row i's support is exactly the 6 consecutive
block-columns 2(i-2)..2i+1 (clipped at the chain ends).  Padding 4
virtual block-columns on each side and 2 virtual block-rows on each
end makes every window structurally IDENTICAL — a (W+4-row, 2W+4-col)
slab with static local connectivity (row r', edge j -> local column
2r'+j-4) — so the whole slide is one `lax.scan` over `dynamic_slice`d
slabs: one compile, static shapes, compute per slide independent of L.
Per-edge shifts (which do vary along the chain) ride in a sliced
(W+4, 6) table and feed traced-shift rolls.

Semantics notes:
  * Window rows are updated with the SAME arithmetic as the reference
    decoder for the chosen sweep (golden two-min contract): with
    sweep='flooding' a window covering the full chain (W = mb)
    reproduces the reference flooding decoder bit-exactly, and with
    sweep='layered' (r5) it reproduces the reference LAYERED decoder
    bit-exactly (both tested).
  * The VN (posterior) pass inside the slab also sums the FROZEN
    check messages of the two rows behind and the two (still-zero)
    rows ahead of the window — that is what makes windowed BP exact
    restricted-schedule BP on the true graph rather than an
    approximation on a truncated one.
  * Output harvesting: once the window has passed row p, the columns
    of position p-2 are never touched again, so hard decisions read
    from the final posterior state are IDENTICAL to bits committed
    streaming as the window slides (no look-ahead is gained).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from tpu_ldpc.codes.code import LdpcCode
from tpu_ldpc.golden.decoder import SP_MAX_MAG, SP_MIN_MAG

_ABSENT_MAG = 1.0e30  # absent-edge magnitude: never the row minimum
_DEG = 6              # row support width in block-columns (w=2 chains)


def banded_tables(code: LdpcCode):
    """(S, M): per-row shift/presence tables of a banded SC chain.

    S, M are (mb, 6); edge j of block-row i targets block-column
    2(i-2)+j.  Raises ValueError if the base matrix is not banded this
    way (only `make_sc_base_graph`-shaped chains are supported).
    """
    B, mb, nb = code.B, code.mb, code.nb
    S = np.zeros((mb, _DEG), dtype=np.int32)
    M = np.zeros((mb, _DEG), dtype=bool)
    claimed = np.zeros((mb, nb), dtype=bool)
    for i in range(mb):
        for j in range(_DEG):
            g = 2 * (i - 2) + j
            if 0 <= g < nb and B[i, g] >= 0:
                S[i, j] = B[i, g]
                M[i, j] = True
                claimed[i, g] = True
    if not np.array_equal(claimed, np.asarray(B) >= 0):
        raise ValueError(
            "base matrix is not a width-2 banded SC chain; windowed "
            "decoding requires make_sc_base_graph structure"
        )
    return S, M


@functools.lru_cache(maxsize=32)
def build_windowed_decoder(
    code: LdpcCode,
    window: int,
    iters_per_window: int = 2,
    algo: str = "minsum",
    alpha: float = 0.75,
    beta: float = 0.0,
    dtype=jnp.float32,
    sweep: str = "flooding",
):
    """Jitted windowed decoder: llr (batch, n) -> (bits, ok, iters_used).

    `window` counts block-rows; each slide runs `iters_per_window`
    iterations on those rows, then advances one row.  iters_used is
    the constant total (n_windows * iters_per_window) — windowed
    decoding has no global early-termination point.

    sweep (r5): the within-window schedule — 'flooding' (CN pass on
    all window rows, then one VN pass) or 'layered' (rows swept
    top-to-bottom with immediate posterior updates, the same
    arithmetic contract as the reference layered decoder: per edge
    p_new = (p_rot - R_old) + r_out, set back in variable
    coordinates).  The layered sweep points the same direction as the
    window slide, reinforcing the decode wave — measured to need
    fewer iterations per position for equal FER (the r2 full-graph
    result that row-layered halves SC FER at equal iters, now inside
    the window).  A full-width single-slide layered window reproduces
    the reference layered decoder bit-exactly (tests/test_windowed).
    """
    if algo not in ("minsum", "sumproduct", "sumproduct-fast"):
        raise ValueError(f"unknown algo {algo!r}")
    if sweep not in ("flooding", "layered"):
        raise ValueError(f"unknown sweep {sweep!r}")
    S_np, M_np = banded_tables(code)
    Z, nb, mb = code.Z, code.nb, code.mb
    W = int(window)
    if not 1 <= W <= mb:
        raise ValueError(f"window must be in [1, mb={mb}], got {W}")
    n_windows = mb - W + 1
    total_iters = n_windows * iters_per_window

    # padded tables: 2 virtual (edge-free) rows on each end
    S_pad = jnp.asarray(np.pad(S_np, ((2, 2), (0, 0))))
    M_pad = jnp.asarray(np.pad(M_np, ((2, 2), (0, 0))))
    SLAB_C = 2 * W + 4    # slab block-columns
    SLAB_R = W + 4        # slab block-rows (window + 2 frozen each side)

    def phi(x):
        x = jnp.clip(x, SP_MIN_MAG, SP_MAX_MAG)
        return -jnp.log(jnp.tanh(x * 0.5))

    def cn_row(qs, ms):
        """CN update for one window row: 6 (batch, Z) inputs + presence
        masks -> 6 extrinsic outputs (absent edges -> 0).  Two-min scan
        in edge order matches the golden first-occurrence contract."""
        mags = [jnp.where(m, jnp.abs(q), _ABSENT_MAG)
                for q, m in zip(qs, ms)]
        sgns = [jnp.where(m & (q < 0), -1.0, 1.0).astype(q.dtype)
                for q, m in zip(qs, ms)]
        total_sign = sgns[0]
        for e in range(1, _DEG):
            total_sign = total_sign * sgns[e]
        if algo == "sumproduct":
            phis = [phi(m) for m in mags]  # phi(ABSENT) ~ 0: exact mask
            tot = phis[0]
            for e in range(1, _DEG):
                tot = tot + phis[e]
            outs = [(total_sign * sgns[e]) * phi(tot - phis[e])
                    for e in range(_DEG)]
        elif algo == "sumproduct-fast":
            # lambda-min2 PWL (golden contract in golden/decoder.py).
            # ABSENT padding is exact here: f(x, ABSENT) == x in fp32
            # (ctilde saturates to 0 long before 1e30), which also
            # reproduces the golden deg-2 exact case; SC chains have
            # min row degree 2, so the golden deg-1 convention is
            # unreachable in this decoder.
            from tpu_ldpc.decode.reference import _fpair_jnp

            big = jnp.full_like(mags[0], jnp.inf)
            m1, m2, m3 = mags[0], big, big
            a1 = jnp.zeros_like(mags[0], dtype=jnp.int32)
            a2 = jnp.full_like(a1, -1)
            for t in range(1, _DEG):
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
            outs = [
                (total_sign * sgns[e]) * jnp.where(
                    a1 == e, f23, jnp.where(a2 == e, f13, f12))
                for e in range(_DEG)
            ]
        else:
            big = jnp.full_like(mags[0], jnp.inf)
            min1, min2 = mags[0], big
            argmin = jnp.zeros_like(mags[0], dtype=jnp.int32)
            for e in range(1, _DEG):
                m = mags[e]
                new = m < min1
                min2 = jnp.where(new, min1, jnp.minimum(min2, m))
                argmin = jnp.where(new, e, argmin)
                min1 = jnp.where(new, m, min1)
            outs = []
            for e in range(_DEG):
                mag = jnp.where(argmin == e, min2, min1)
                mag = jnp.maximum(mag - beta, 0.0)
                outs.append((total_sign * sgns[e]) * (alpha * mag))
        return [jnp.where(m, o, 0.0) for o, m in zip(outs, ms)]

    # static VN incidence: slab column c <- (slab row r', edge j=c+4-2r')
    vn_inc = [
        [(rp, c + 4 - 2 * rp) for rp in range(SLAB_R)
         if 0 <= c + 4 - 2 * rp < _DEG]
        for c in range(SLAB_C)
    ]

    # full-graph syndrome check on the final hard decisions
    def syndrome_ok(bits_cols):  # (batch, nb, Z) int32
        ok = None
        for i in range(mb):
            acc = None
            for j in range(_DEG):
                if not M_np[i, j]:
                    continue
                g = 2 * (i - 2) + j
                v = jnp.roll(bits_cols[:, g, :], -int(S_np[i, j]), axis=-1)
                acc = v if acc is None else acc + v
            row_ok = jnp.all(acc % 2 == 0, axis=-1)
            ok = row_ok if ok is None else ok & row_ok
        return ok

    @jax.jit
    def decode_fn(llr):
        llr = llr.astype(dtype)
        batch = llr.shape[0]
        # 4 virtual block-columns each side (never read through real
        # edges; they only uniformize slab indexing)
        L = jnp.pad(llr.reshape(batch, nb, Z), ((0, 0), (4, 4), (0, 0)))

        def window_step(carry, p):
            P, R = carry  # P (batch, nb+8, Z); R (batch, mb+4, 6, Z)
            Lw = jax.lax.dynamic_slice_in_dim(L, 2 * p, SLAB_C, axis=1)
            Pw = jax.lax.dynamic_slice_in_dim(P, 2 * p, SLAB_C, axis=1)
            Rw = jax.lax.dynamic_slice_in_dim(R, p, SLAB_R, axis=1)
            Sw = jax.lax.dynamic_slice_in_dim(S_pad, p, SLAB_R, axis=0)
            Mw = jax.lax.dynamic_slice_in_dim(M_pad, p, SLAB_R, axis=0)

            def row_inputs(Pw, Rw, rp):
                """Extrinsic CN inputs of slab row rp: per edge j,
                q = roll(P_col, -S) - R_old, plus presence masks —
                the q-construction contract shared by BOTH sweeps."""
                qs, ms = [], []
                for j in range(_DEG):
                    c = 2 * rp + j - 4
                    qs.append(
                        jnp.roll(Pw[:, c, :], -Sw[rp, j], axis=-1)
                        - Rw[:, rp, j, :]
                    )
                    ms.append(Mw[rp, j])
                return qs, ms

            def one_iter(_, PR):
                Pw, Rw = PR
                # CN pass on the window rows (slab rows 2..W+1)
                new_rows = []
                for rp in range(2, W + 2):
                    qs, ms = row_inputs(Pw, Rw, rp)
                    new_rows.append(jnp.stack(cn_row(qs, ms), axis=1))
                Rn = jnp.concatenate(
                    [Rw[:, :2], jnp.stack(new_rows, axis=1), Rw[:, W + 2:]],
                    axis=1,
                )
                # VN pass over all slab columns; the frozen rows (slab
                # 0,1 behind and W+2,W+3 ahead) contribute their
                # existing messages — exact restricted-schedule BP
                cols = []
                for c in range(SLAB_C):
                    pc = Lw[:, c, :]
                    for rp, j in vn_inc[c]:
                        contrib = jnp.roll(Rn[:, rp, j, :], Sw[rp, j],
                                           axis=-1)
                        pc = pc + jnp.where(Mw[rp, j], contrib, 0.0)
                    cols.append(pc)
                return jnp.stack(cols, axis=1), Rn

            def one_iter_layered(_, PR):
                # rows swept top-to-bottom with immediate posterior
                # set-back — the reference layered arithmetic
                # (p_new = (p_rot - R_old) + r_out in check coords,
                # rolled back and SET).  The invariant P == L + sum of
                # rolled R over ALL slab rows is preserved per row
                # update, so frozen rows' contributions ride inside P
                # without a VN pass.
                Pw, Rw = PR
                for rp in range(2, W + 2):
                    qs, ms = row_inputs(Pw, Rw, rp)
                    outs = cn_row(qs, ms)
                    for j in range(_DEG):
                        c = 2 * rp + j - 4
                        p_new = jnp.roll(qs[j] + outs[j], Sw[rp, j],
                                         axis=-1)
                        # absent edges: q already reconstructs P and
                        # out is 0, so p_new == P; the where is a
                        # safety net, not arithmetic
                        Pw = Pw.at[:, c, :].set(
                            jnp.where(Mw[rp, j], p_new, Pw[:, c, :]))
                        Rw = Rw.at[:, rp, j, :].set(
                            jnp.where(Mw[rp, j], outs[j],
                                      Rw[:, rp, j, :]))
                return Pw, Rw

            Pw, Rw = jax.lax.fori_loop(
                0, iters_per_window,
                one_iter if sweep == "flooding" else one_iter_layered,
                (Pw, Rw)
            )
            P = jax.lax.dynamic_update_slice_in_dim(P, Pw, 2 * p, axis=1)
            R = jax.lax.dynamic_update_slice_in_dim(
                R, Rw[:, 2:W + 2], p + 2, axis=1
            )
            return (P, R), None

        P = L
        R = jnp.zeros((batch, mb + 4, _DEG, Z), dtype=dtype)
        (P, _), _ = jax.lax.scan(
            window_step, (P, R), jnp.arange(n_windows, dtype=jnp.int32)
        )
        bits_cols = (P[:, 4:4 + nb, :] < 0).astype(jnp.int32)
        ok = syndrome_ok(bits_cols)
        bits = bits_cols.reshape(batch, nb * Z).astype(jnp.uint8)
        iu = jnp.full(batch, total_iters, dtype=jnp.int32)
        return bits, ok, iu

    return decode_fn
