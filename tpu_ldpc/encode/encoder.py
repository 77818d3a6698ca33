"""Device encoders (SURVEY.md C4): two systematic QC encoding paths.

(a) `generator`: dense-generator matmul — parity p = u @ M^T over GF(2),
    realized as an fp32 matrix product followed by mod 2 (bit counts
    < 2^24 are exact in fp32).  The product is pinned to
    Precision.HIGHEST, so no backend may lower it to a reduced-precision
    (TF32) product; the GPU smoke run (chip_smoke.py) checks it against
    the golden encoder bit for bit.
(b) `dual_diagonal`: O(n) back-substitution exploiting the 802.11n-style
    parity structure every registry code is built with (closing weight-3
    column h with shifts (s,0,s) at rows (0, mb//2, mb-1), shift-0 dual
    diagonal): summing all block-rows cancels the dual diagonal and the
    two P^s terms, giving p0 = sum_i A_i u, then p_{i+1} back-substitutes.

(c) `pivot`: general path for arbitrary H — including rank-deficient
    matrices (terminated SC-LDPC chains, imported alist codes) where
    the trailing parity block is not invertible: RREF over GF(2) picks
    a pivot/information-set split, pivot bits solved by one matmul.
    `encode_fn.k` is the TRUE dimension n - rank(H) (>= design k);
    `encode_fn.info_cols` maps info bits to codeword positions.

All paths are jit-compiled and verified equal to the golden encoder.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from tpu_ldpc.codes.code import LdpcCode


@functools.lru_cache(maxsize=64)
def build_encoder(code: LdpcCode, method: str = "generator"):
    """Build a jitted encoder: u (batch, k) uint8 -> c (batch, n) uint8."""
    if method == "generator":
        MT = jnp.asarray(code.parity_M.T, dtype=jnp.float32)  # (k, m)

        @jax.jit
        def encode_fn(u):
            uf = u.astype(jnp.float32)
            p = jnp.dot(uf, MT, preferred_element_type=jnp.float32,
                        precision=jax.lax.Precision.HIGHEST)
            p = jnp.mod(p, 2.0).astype(jnp.uint8)
            return jnp.concatenate([u.astype(jnp.uint8), p], axis=1)

        return encode_fn

    if method == "pivot":
        # General path for ARBITRARY H (alist imports, rank-deficient
        # terminated SC-LDPC chains, ...): row-reduce H, take the
        # non-pivot columns as the information set (true dimension
        # n - rank >= design k), and solve the pivot bits with one
        # matmul (Precision.HIGHEST, as above): RREF row r says
        # c[pivot_r] = sum_{f in free} R[r,f] c_f.
        # Systematic in the free positions, not necessarily the leading
        # k columns; encode_fn.k / .info_cols expose the mapping.
        import scipy.sparse as sp

        from tpu_ldpc.golden.encoder import gf2_row_reduce

        Hd = (np.asarray(sp.csr_matrix(code.H).todense()) % 2).astype(np.uint8)
        n = Hd.shape[1]
        rref, pivots = gf2_row_reduce(Hd)
        rank = len(pivots)
        free = np.asarray(
            sorted(set(range(n)) - set(pivots)), dtype=np.int64)
        pivots = np.asarray(pivots, dtype=np.int64)
        MT = jnp.asarray(rref[:rank][:, free].T, dtype=jnp.float32)
        free_j = jnp.asarray(free)
        piv_j = jnp.asarray(pivots)
        true_k = n - rank

        @jax.jit
        def _pivot_encode(u):
            uf = u.astype(jnp.float32)
            p = jnp.mod(
                jnp.dot(uf, MT, preferred_element_type=jnp.float32,
                        precision=jax.lax.Precision.HIGHEST), 2.0
            ).astype(jnp.uint8)
            c = jnp.zeros((u.shape[0], n), jnp.uint8)
            c = c.at[:, free_j].set(u.astype(jnp.uint8))
            return c.at[:, piv_j].set(p)

        def encode_fn(u):
            return _pivot_encode(u)

        encode_fn.k = true_k
        encode_fn.info_cols = free
        return encode_fn

    if method == "dual_diagonal":
        B, Z, mb, nb = code.B, code.Z, code.mb, code.nb
        kb = nb - mb
        # closing column structure
        h_rows = [i for i in range(mb) if B[i, kb] >= 0]
        if len(h_rows) != 3 or h_rows[0] != 0 or h_rows[-1] != mb - 1:
            raise ValueError(
                f"{code.name}: parity part is not in dual-diagonal form"
            )
        r_mid = h_rows[1]
        s_top = int(B[0, kb])
        if int(B[r_mid, kb]) != 0 or int(B[mb - 1, kb]) != s_top:
            raise ValueError(
                f"{code.name}: closing column shifts are not (s, 0, s)"
            )
        info_blocks = [
            [(j, int(B[i, j])) for j in range(kb) if B[i, j] >= 0]
            for i in range(mb)
        ]

        @jax.jit
        def encode_fn(u):
            batch = u.shape[0]
            ub = u.astype(jnp.int32).reshape(batch, kb, Z)
            # s_i = A_i u  (XOR accumulation, kept as int sums mod 2)
            s = []
            for i in range(mb):
                acc = jnp.zeros((batch, Z), dtype=jnp.int32)
                for j, sh in info_blocks[i]:
                    acc = acc ^ jnp.roll(ub[:, j, :], -sh, axis=-1)
                s.append(acc)
            # p0 = sum of all block-row syndromes
            p0 = s[0]
            for i in range(1, mb):
                p0 = p0 ^ s[i]
            # back-substitution
            p = [p0]
            p1 = s[0] ^ jnp.roll(p0, -s_top, axis=-1)
            p.append(p1)
            for i in range(1, mb - 1):
                nxt = s[i] ^ p[i]
                if i == r_mid:
                    nxt = nxt ^ p0  # shift-0 closing-column entry
                p.append(nxt)
            parity = jnp.stack(p[:mb], axis=1).reshape(batch, mb * Z)
            return jnp.concatenate(
                [u.astype(jnp.uint8), parity.astype(jnp.uint8)], axis=1
            )

        return encode_fn

    raise ValueError(f"unknown encode method {method!r}")


def encode(code: LdpcCode, u, method: str = "generator"):
    fn = build_encoder(code, method)
    return fn(jnp.asarray(u))


def select_encoder(code: LdpcCode):
    """Encoder selection shared by the MC step builders (single-device
    and sharded): the dense-generator path when the trailing parity
    block is invertible, else the general pivot path.

    Returns (encode_fn, k, info_cols): k is the true info dimension and
    info_cols is None for the generator path (info bits are the leading
    k columns) or the pivot information-set column indices.
    """
    try:
        return build_encoder(code, "generator"), code.k, None
    except ValueError:
        fn = build_encoder(code, "pivot")
        return fn, fn.k, fn.info_cols
