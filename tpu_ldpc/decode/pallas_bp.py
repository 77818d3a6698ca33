"""Fused belief-propagation decoder for the GPU: Pallas through Triton.

One program decodes a tile of `tile` codewords for all iterations.  Every
per-block tensor is (Zp, tile): the lift axis Z, padded to the next power
of two Zp (Triton tensors have power-of-two sizes), by the codewords of
the tile.

  * State.  The CN->VN messages R (E, Zp, tile), the posterior P and the
    channel LLRs L (nb, Zp, tile) live in a slab of device memory that
    only this program touches (the Triton route has no scratch memory);
    a slab of a few tens of KB stays in the SM's L1 and the L2.  Nothing
    is carried in HBM traffic between kernels: the whole decode is one
    launch.
  * Circulant shifts.  Block (i, j, s) joins check r of block-row i to
    variable (r + s) % Z of block-col j.  The CN pass gathers P[j] into
    check coordinates with a load at row index (r + s) % Z, the VN pass
    gathers R back with index (v - s) % Z, and the layered sweep
    scatters its new posterior with a store at (r + s) % Z.  All index
    tensors are static.
  * Padding Z.  Rows r >= Z index themselves, so pad rows only ever meet
    pad rows: the CN update is elementwise in r, and the syndrome count
    masks r >= Z out.  Pad rows never enter a real min, sign product or
    syndrome.
  * Threads of a program exchange state through memory (a gather reads
    rows another thread wrote), so a block barrier separates every pass
    that writes state from the next pass that gathers it.
  * Min-sum CN update: sign-magnitude.  Magnitudes by abs, the exclusive
    minimum by a balanced tree of mins (min is exact, so this equals the
    golden two-min scan for every tie pattern), signs as int32 sign bits
    taken from `q < 0` (as golden does: -0.0 counts as positive),
    combined by XOR and re-attached with OR.  The only float products
    (alpha * magnitude) feed the OR, never an add, so no FMA contraction
    can change their rounding: bit-exact against golden float32.
  * Early termination: per-codeword done flags; converged codewords stop
    writing P (masked stores), so their posterior is frozen; the tile's
    while loop exits when every codeword of the tile has converged.
    iters_used follows golden's sequential semantics exactly.  On the
    flooding schedule the syndrome of the previous posterior is taken
    from the CN pass's own gathers, at no extra memory pass.

The same generator emits exact sum-product (sign / phi form, compared
with golden by tolerance) and the row-layered schedule.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from tpu_ldpc import backend
from tpu_ldpc.codes.code import LdpcCode
from tpu_ldpc.golden.decoder import SP_MAX_MAG, SP_MIN_MAG

SIGN_MASK = np.int32(np.uint32(0x80000000))
KERNEL_ALGOS = ("minsum", "sumproduct")
# Per-tile state the kernel keeps in flight (R, P and L in fp32): one SM's
# 256 KB of L1/shared memory, less what a block may not claim.  A code
# whose state for ONE codeword exceeds it is refused (decode.api then
# routes it to the XLA path, or across cards to dist/ring.py or
# dist/partitioned.py).
STATE_BUDGET_BYTES = 227 * 1024


def fits(code: LdpcCode) -> bool:
    """The kernel's capacity rule: one codeword's state fits one SM."""
    return code.layout.state_bytes(1) <= STATE_BUDGET_BYTES


def _next_pow2(x: int) -> int:
    return 1 << (int(x) - 1).bit_length()


def _i32(x):
    return jax.lax.bitcast_convert_type(x, jnp.int32)


def _f32(x):
    return jax.lax.bitcast_convert_type(x, jnp.float32)


def _sign_bit(x):
    """SIGN_MASK where x < 0, else 0 (-0.0 is positive, as in golden)."""
    return jnp.where(x < 0, SIGN_MASK, np.int32(0))


def _xor_tree(vals):
    vals = list(vals)
    while len(vals) > 1:
        nxt = [a ^ b for a, b in zip(vals[::2], vals[1::2])]
        if len(vals) % 2:
            nxt.append(vals[-1])
        vals = nxt
    return vals[0]


def _excl_min(mags):
    """excl[e] = min of the other edges' magnitudes, by a balanced tree:
    each half's min is combined with what lies outside it, so the depth
    is log2(d) and no serial prefix/suffix chain is built.  A degree-1
    row sends its own magnitude (golden)."""
    if len(mags) == 1:
        return [mags[0]]
    memo = {}

    def min_of(lo, hi):
        if (lo, hi) not in memo:
            if hi - lo == 1:
                memo[lo, hi] = mags[lo]
            else:
                mid = (lo + hi) // 2
                memo[lo, hi] = jnp.minimum(min_of(lo, mid), min_of(mid, hi))
        return memo[lo, hi]

    def rec(lo, hi, outside):
        if hi - lo == 1:
            return [outside]
        mid = (lo + hi) // 2
        left, right = min_of(lo, mid), min_of(mid, hi)
        out_l = right if outside is None else jnp.minimum(outside, right)
        out_r = left if outside is None else jnp.minimum(outside, left)
        return rec(lo, mid, out_l) + rec(mid, hi, out_r)

    return rec(0, len(mags), None)


def _cn_minsum(qs, alpha: float, beta: float):
    sbits = [_sign_bit(q) for q in qs]
    total = _xor_tree(sbits)
    outs = []
    for e, mag in enumerate(_excl_min([jnp.abs(q) for q in qs])):
        if beta != 0.0:
            mag = jnp.maximum(mag - beta, 0.0)
        if alpha != 1.0:
            mag = mag * alpha  # feeds only the OR below: never FMA-fused
        outs.append(_f32(_i32(mag) | (total ^ sbits[e])))
    return outs


def _phi(x):
    x = jnp.clip(x, SP_MIN_MAG, SP_MAX_MAG)
    return -jnp.log(jnp.tanh(x * 0.5))


def _cn_sumproduct(qs, alpha: float, beta: float):
    del alpha, beta
    sbits = [_sign_bit(q) for q in qs]
    total = _xor_tree(sbits)
    phis = [_phi(jnp.abs(q)) for q in qs]
    tot = phis[0]
    for p in phis[1:]:
        tot = tot + p
    return [_f32(_i32(_phi(tot - p)) | (total ^ sb))
            for p, sb in zip(phis, sbits)]


@functools.lru_cache(maxsize=64)
def build_pallas_decoder(
    code: LdpcCode,
    algo: str = "minsum",
    iters: int = 50,
    alpha: float = 0.75,
    beta: float = 0.0,
    schedule: str = "flooding",
    early_stop: bool = True,
    tile: int = 1,
    interpret: bool = False,
):
    """Build a jitted GPU decoder: llr (batch, n) -> (bits, ok, iters_used).

    tile: codewords per program (a power of two).  One codeword per
      program, on one warp, measured fastest on an H100 (judged code:
      tiles of 1, 2, 4 and 8 at their best warp counts ran 1.64, 1.96,
      1.91 and 3.31 ms per 4096-codeword batch, flooding-50; at tile 1,
      one warp beat two and four on the judged and wifi_r12_z81 codes
      except wifi flooding without early stop, where four warps were 3%
      faster).
    interpret: run the kernel in the Pallas interpreter (tests on the
      CPU).  Without it the kernel needs a GPU and refuses other
      backends.

    Raises ValueError for an algorithm or schedule the kernel does not
    carry, or a code over the kernel's capacity (`fits`).
    """
    if algo not in KERNEL_ALGOS:
        raise ValueError(f"kernel algos are {KERNEL_ALGOS}, not {algo!r}")
    if schedule not in ("flooding", "layered"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if not fits(code):
        raise ValueError(
            f"{code.name}: {code.layout.state_bytes(1)} B of state per "
            f"codeword exceeds the kernel's {STATE_BUDGET_BYTES} B")
    if not interpret:
        backend.require_gpu("the Pallas Triton decoder kernel")
    lay = code.layout
    Z, mb, nb, E, n = lay.Z, lay.mb, lay.nb, lay.E, lay.n
    Zp = _next_pow2(Z)
    tile = int(tile)
    if tile < 1 or tile & (tile - 1):
        raise ValueError(f"tile must be a power of two, got {tile}")
    ecol = [int(c) for c in lay.edge_col]
    eshift = [int(s) % Z for s in lay.edge_shift]
    row_edges = [lay.row_edges(i) for i in range(mb)]
    col_edges = [lay.col_edges(j) for j in range(nb)]
    cn_update = _cn_minsum if algo == "minsum" else _cn_sumproduct
    f_alpha, f_beta = float(alpha), float(beta)

    def kernel(L_ref, P_ref, R_ref, ok_ref, iu_ref):
        r = jax.lax.broadcasted_iota(jnp.int32, (Zp, tile), 0)
        col = jax.lax.broadcasted_iota(jnp.int32, (Zp, tile), 1)
        real = r < Z
        # row index (r + s) % Z for real rows, r for pad rows; built once
        # here, outside the loops that use them
        index = {}
        for s in {*eshift, *((Z - s) % Z for s in eshift)}:
            v = r + s
            index[s] = jnp.where(real, jnp.where(v >= Z, v - Z, v), r)
        rows_at = index.__getitem__

        def gather(ref, k, s):
            return ref[k] if s == 0 else ref[k, rows_at(s), col]

        def barrier():
            if not interpret:
                plgpu.debug_barrier()

        def violations(par):
            """(tile,) int32: real check rows of one block-row unsatisfied."""
            return jnp.sum(jnp.where(real & (par != 0), 1, 0), axis=0)

        def syndrome():
            viol = jnp.zeros((tile,), jnp.int32)
            for i in range(mb):
                viol = viol + violations(_xor_tree(
                    [_sign_bit(gather(P_ref, ecol[e], eshift[e]))
                     for e in row_edges[i]]))
            return viol

        for j in range(nb):
            P_ref[j] = L_ref[j]
        zeros = jnp.zeros((Zp, tile), jnp.float32)
        for e in range(E):
            R_ref[e] = zeros
        barrier()

        def flooding(active):
            """One flooding iteration.  Returns the violation count of the
            posterior it started from (None without early stop); the VN
            pass writes only the codewords still active after that check
            (`active` maps the count to the new active mask)."""
            viol = jnp.zeros((tile,), jnp.int32) if early_stop else None
            for i in range(mb):
                ts = [gather(P_ref, ecol[e], eshift[e])
                      for e in row_edges[i]]
                if early_stop:
                    viol = viol + violations(
                        _xor_tree([_sign_bit(t) for t in ts]))
                qs = [t - R_ref[e] for t, e in zip(ts, row_edges[i])]
                for e, r_new in zip(row_edges[i],
                                    cn_update(qs, f_alpha, f_beta)):
                    R_ref[e] = r_new
            barrier()
            live = None if viol is None else active(viol)
            for j in range(nb):
                p = L_ref[j]
                for e in col_edges[j]:  # ascending block-row order
                    p = p + gather(R_ref, e, (Z - eshift[e]) % Z)
                if live is None:
                    P_ref[j] = p
                else:
                    plgpu.store(P_ref.at[j], p,
                                mask=jnp.broadcast_to(live[None, :],
                                                      (Zp, tile)))
            barrier()
            return viol

        def layered(live):
            """One layered sweep; `live` (tile,) masks the P writes."""
            for i in range(mb):
                es = row_edges[i]
                qs = [gather(P_ref, ecol[e], eshift[e]) - R_ref[e]
                      for e in es]
                for e, q, r_new in zip(es, qs,
                                       cn_update(qs, f_alpha, f_beta)):
                    p_new = q + r_new
                    if live is None and eshift[e] == 0:
                        P_ref[ecol[e]] = p_new
                    else:
                        mask = (jnp.broadcast_to(live[None, :], (Zp, tile))
                                if live is not None else None)
                        plgpu.store(P_ref.at[ecol[e], rows_at(eshift[e]),
                                             col], p_new, mask=mask)
                    R_ref[e] = r_new
                barrier()

        done0 = jnp.zeros((tile,), jnp.int32)
        iu0 = jnp.full((tile,), iters, jnp.int32)
        if not early_stop:
            def body(_, c):
                if schedule == "flooding":
                    flooding(None)
                else:
                    layered(None)
                return c

            jax.lax.fori_loop(0, iters, body, 0)
            ok_ref[...] = jnp.where(syndrome() == 0, 1, 0)
            iu_ref[...] = iu0
            return

        def cond(c):
            it, done, _ = c
            return (it <= iters) & (jnp.min(done) == 0)

        if schedule == "flooding":
            # iteration `it` checks the posterior of iteration it-1 (it=1
            # checks the channel decision: iters_used 0)
            def body(c):
                it, done, iu = c
                state = {}

                def active(viol):
                    newly = (done == 0) & (viol == 0)
                    state["newly"] = newly
                    return (done == 0) & ~newly

                flooding(active)
                newly = state["newly"]
                return (it + 1, jnp.where(newly, 1, done),
                        jnp.where(newly, it - 1, iu))

            _, done, iu = jax.lax.while_loop(
                cond, body, (jnp.int32(1), done0, iu0))
            # the last posterior still needs its own check
            done = jnp.where(syndrome() == 0, 1, done)
        else:
            done0 = jnp.where(syndrome() == 0, 1, 0)
            iu0 = jnp.where(done0 == 1, 0, iu0)
            barrier()

            def body(c):
                it, done, iu = c
                layered(done == 0)
                newly = (done == 0) & (syndrome() == 0)
                barrier()
                return (it + 1, jnp.where(newly, 1, done),
                        jnp.where(newly, it, iu))

            _, done, iu = jax.lax.while_loop(
                cond, body, (jnp.int32(1), done0, iu0))
        ok_ref[...] = done
        iu_ref[...] = iu

    @jax.jit
    def decode_fn(llr):
        batch = llr.shape[0]
        padded = -(-batch // tile) * tile
        T = padded // tile
        x = llr.astype(jnp.float32)
        if padded != batch:
            # pad codewords with strong "zero codeword" LLRs: they
            # converge at once and never hold the tile's exit back
            x = jnp.pad(x, ((0, padded - batch), (0, 0)),
                        constant_values=100.0)
        x = jnp.pad(x.reshape(padded, nb, Z), ((0, 0), (0, 0), (0, Zp - Z)))
        x = x.reshape(T, tile, nb, Zp).transpose(0, 2, 3, 1)
        P, _, ok, iu = pl.pallas_call(
            kernel,
            grid=(T,),
            in_specs=[pl.BlockSpec((None, nb, Zp, tile),
                                   lambda t: (t, 0, 0, 0))],
            out_specs=[
                pl.BlockSpec((None, nb, Zp, tile), lambda t: (t, 0, 0, 0)),
                pl.BlockSpec((None, E, Zp, tile), lambda t: (t, 0, 0, 0)),
                pl.BlockSpec((None, tile), lambda t: (t, 0)),
                pl.BlockSpec((None, tile), lambda t: (t, 0)),
            ],
            out_shape=[
                jax.ShapeDtypeStruct((T, nb, Zp, tile), jnp.float32),
                jax.ShapeDtypeStruct((T, E, Zp, tile), jnp.float32),
                jax.ShapeDtypeStruct((T, tile), jnp.int32),
                jax.ShapeDtypeStruct((T, tile), jnp.int32),
            ],
            backend="triton",
            compiler_params=plgpu.CompilerParams(num_warps=1, num_stages=1),
            interpret=interpret,
            name=f"bp_{algo}_{schedule}",
        )(x)
        bits = (P[:, :, :Z, :] < 0).transpose(0, 3, 1, 2)
        bits = bits.reshape(padded, n)[:batch].astype(jnp.uint8)
        return bits, ok.reshape(padded)[:batch] > 0, iu.reshape(padded)[:batch]

    return decode_fn
