"""Batched jnp hard-decision decoders (bit-flipping family).

Decoder-family breadth beyond BP (SURVEY.md C6/C7 siblings): classic
hard-decision decoding for high-throughput / low-complexity operating
points and for hard-output channels (channel/bsc.py).  Same public
contract as every other decoder: llr (batch, n) -> (bits, ok,
iters_used), so they drop into the MC harness via DecodeCfg(algo=...).

Implementations follow the golden contract (golden/hard.py) exactly —
integer syndrome/majority arithmetic for ``bitflip`` and fp32
edge-order min / ascending-row accumulation with first-occurrence
argmax for ``wbf`` — so both are tested bit-exact against golden.

Shape: everything is block-circulant rolls over (batch, nb, Z)
states, the same layout as the BP reference decoder; the
work per iteration is O(edges) integer ops, far below the BP kernels,
so the XLA-compiled form is already at the memory-traffic floor and no
Pallas variant is warranted.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from tpu_ldpc.codes.code import LdpcCode


def _block_structure(code: LdpcCode):
    B = code.B
    mb, nb = B.shape
    edges = [(i, j, int(B[i, j]))
             for i in range(mb) for j in range(nb) if B[i, j] >= 0]
    row_edges = [[e for e, (i, _, _) in enumerate(edges) if i == r]
                 for r in range(mb)]
    col_edges = [[e for e, (_, j, _) in enumerate(edges) if j == c]
                 for c in range(nb)]
    return edges, row_edges, col_edges


@functools.lru_cache(maxsize=64)
def build_hard_decoder(
    code: LdpcCode,
    algo: str = "bitflip",
    iters: int = 50,
):
    """Jitted hard decoder: llr (batch, n) -> (bits, ok, iters_used)."""
    if algo not in ("bitflip", "wbf"):
        raise ValueError(f"unknown hard algo {algo!r}")
    edges, row_edges, col_edges = _block_structure(code)
    Z, nb, mb = code.Z, code.nb, code.mb
    col_deg = np.array([len(col_edges[j]) for j in range(nb)], np.int32)

    def syndrome(x):  # x (batch, nb, Z) int32 -> (batch, mb, Z) in {0,1}
        rows = []
        for i in range(mb):
            acc = None
            for e in row_edges[i]:
                _, j, s = edges[e]
                v = jnp.roll(x[:, j, :], -s, axis=-1)
                acc = v if acc is None else acc + v
            rows.append(acc % 2)
        return jnp.stack(rows, axis=1)

    def bitflip_step(x, syn, mag):
        del mag
        flips = []
        for j in range(nb):
            u = None
            for e in col_edges[j]:
                i, _, s = edges[e]
                v = jnp.roll(syn[:, i, :], s, axis=-1)
                u = v if u is None else u + v
            flips.append((2 * u > col_deg[j]).astype(jnp.int32))
        return x ^ jnp.stack(flips, axis=1)

    def wbf_step(x, syn, mag):
        # check reliabilities: sequential edge-order min (fp32, matches
        # golden exactly — min is order-independent in fp)
        w = []
        for i in range(mb):
            acc = None
            for e in row_edges[i]:
                _, j, s = edges[e]
                v = jnp.roll(mag[:, j, :], -s, axis=-1)
                acc = v if acc is None else jnp.minimum(acc, v)
            w.append(acc)
        contrib = [
            (2 * syn[:, i, :] - 1).astype(jnp.float32) * w[i]
            for i in range(mb)
        ]
        # energies: ascending block-row accumulation (golden order)
        cols = []
        for j in range(nb):
            E = None
            for e in col_edges[j]:
                i, _, s = edges[e]
                v = jnp.roll(contrib[i], s, axis=-1)
                E = v if E is None else E + v
            cols.append(E)
        E = jnp.stack(cols, axis=1).reshape(x.shape[0], nb * Z)
        jstar = jnp.argmax(E, axis=1)  # first-occurrence ties, as golden
        flip = jax.nn.one_hot(jstar, nb * Z, dtype=jnp.int32)
        return x ^ flip.reshape(x.shape)

    step = bitflip_step if algo == "bitflip" else wbf_step

    @jax.jit
    def decode_fn(llr):
        llr = llr.astype(jnp.float32)
        batch = llr.shape[0]
        mag = jnp.abs(llr).reshape(batch, nb, Z)
        x = (llr < 0).astype(jnp.int32).reshape(batch, nb, Z)
        syn = syndrome(x)
        done0 = ~jnp.any(syn.reshape(batch, -1) == 1, axis=1)
        iu0 = jnp.where(done0, 0, iters).astype(jnp.int32)

        def body(it, carry):
            x, syn, done, iu = carry
            x_new = step(x, syn, mag)
            x = jnp.where(done[:, None, None], x, x_new)
            syn = syndrome(x)
            ok_now = ~jnp.any(syn.reshape(batch, -1) == 1, axis=1)
            newly = ok_now & ~done
            iu = jnp.where(newly, it, iu)
            return x, syn, done | ok_now, iu

        x, _, done, iu = jax.lax.fori_loop(
            1, iters + 1, body, (x, syn, done0, iu0)
        )
        bits = x.reshape(batch, nb * Z).astype(jnp.uint8)
        return bits, done, iu

    return decode_fn
