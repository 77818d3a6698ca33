"""Column-partitioned ring BP decoding — the long-blocklength path
(SURVEY.md §5 "long-context analog", §2.2 SP/CP row; design sketched in
dist/partitioned.py's module docstring, realized here).

Block-columns are sharded contiguously over a 'code' mesh axis.  For
ANY banded base graph — each check row's block-column support spans at
most `halo+1` consecutive block-columns, where `halo` is measured from
the layout (max over rows of cmax−cmin); spatially-coupled chains from
make_sc_base_graph are the canonical instance but any coupling width /
columns-per-position qualifies — every check row is assigned to the
device owning its RIGHTMOST block-column, so it can be updated from
that device's columns plus a `halo`-wide window from the LEFT
neighbor, and every column's posterior from its own rows plus boundary
contributions returned by the RIGHT neighbor.  One BP iteration
therefore costs exactly two neighbor `ppermute` steps — the
ring-attention communication shape over ICI — independent of code
length:

    halo:    P[last `halo` block-cols]  --ppermute-->  right neighbor
    (local CN pass over owned rows; local scatter)
    return:  contributions to the left neighbor's last `halo` cols
             --ppermute-->  left neighbor
    (posterior = channel + local scatter + returned scatter)

Single-hop requirement: halo <= block-cols per device (a row's window
may not span more than one neighbor shard); rejected otherwise.

Message state R never leaves its device: sharding the columns shards
the O(E·Z·batch) memory, which is the whole point — this is the path
for codes whose state exceeds one device's memory.  No judged config
needs it (SURVEY §6 sizing), so like partitioned.py it ships as a
working jnp prototype exercised on the fake CPU mesh, not a tuned
Pallas kernel.

SPMD discipline: every collective (two ppermutes + one psum per
iteration) is issued at the TOP level of the iteration body, outside
the per-device `lax.switch` — collectives inside switch branches are
lowered per-branch with independent channel ids and deadlock the mesh
(observed on the CPU backend's rendezvous).  Only the purely local
CN/scatter work is branch-specialized; per-device message state is
padded to a common max edge count so the switch branches agree on
shapes.

Determinism: per-column accumulation sums local before remote
contributions, which reassociates f32 adds vs the sequential golden
order — tests assert near-total frame agreement, as for partitioned.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from jax import shard_map

from tpu_ldpc.codes.code import LdpcCode
from tpu_ldpc.decode.reference import (
    _cn_minsum,
    _cn_sumproduct,
    _cn_sumproduct_fast,
)

def _row_spans(lay):
    """{block-row: (leftmost, rightmost) block-column} of non-empty rows."""
    spans = {}
    for i in range(lay.mb):
        es = lay.row_edges(i)
        if es:
            cols = [int(lay.edge_col[e]) for e in es]
            spans[i] = (min(cols), max(cols))
    return spans


def _ring_geometry(code: LdpcCode, n_dev: int):
    """(block-cols per device, halo, problem): problem is None when the
    ring can decode `code` over `n_dev` devices, else why not."""
    nb = code.layout.nb
    if nb % n_dev:
        return 0, 0, f"nb={nb} block-columns not divisible by {n_dev} devices"
    cpd = nb // n_dev                      # block-cols per device
    # needed halo is OWNER-aligned (the owner of a row is the device
    # holding its rightmost block-column): each row reads back from its
    # owner's first column to its leftmost column, not its full raw span
    halo = max((cmax // cpd * cpd - cmin
                for cmin, cmax in _row_spans(code.layout).values()),
               default=0)
    # halo=0 (block-diagonal base) would make the `P_loc[-halo:]` slice
    # degenerate (-0 == whole array); one spare column costs nothing
    halo = max(halo, 1)
    if halo > cpd:
        return cpd, halo, (
            f"band width {halo} exceeds the {cpd} block-cols per device "
            f"(nb={nb}, {n_dev} devices): a single-hop neighbor halo "
            "cannot span multiple shards — use fewer devices or the "
            "row-striped partitioned decoder")
    return cpd, halo, None


def ring_supports(code: LdpcCode, n_dev: int) -> bool:
    """Whether build_ring_decoder accepts `code` over `n_dev` devices."""
    return _ring_geometry(code, n_dev)[2] is None


@functools.lru_cache(maxsize=16)
def build_ring_decoder(
    code: LdpcCode,
    mesh: Mesh,
    algo: str = "minsum",
    iters: int = 50,
    alpha: float = 0.75,
    beta: float = 0.0,
    axis: str = "code",
):
    """Ring decoder for banded QC codes (SC-LDPC chains of any coupling
    width, or any base graph whose rows have narrow column support):
    llr (batch, n) -> (bits, ok, iters_used).

    Requires: nb divisible by the mesh axis size, and the measured band
    width (max over rows of cmax-cmin block-columns) at most the
    per-device column count (single-hop neighbor halo).
    """
    lay = code.layout
    Z, mb, nb = lay.Z, lay.mb, lay.nb
    n_dev = mesh.shape[axis]
    cpd, halo, problem = _ring_geometry(code, n_dev)
    if problem:
        raise ValueError(problem)
    row_cols = _row_spans(lay)
    owner = {i: cmax // cpd for i, (_, cmax) in row_cols.items()}
    cn_update = {
        "minsum": _cn_minsum,
        "sumproduct": _cn_sumproduct,
        "sumproduct-fast": _cn_sumproduct_fast,
    }[algo]

    # per-device static structure: owned rows + their edges in
    # halo-extended local column coordinates (ext index = j - j0 + halo)
    def device_rows(d):
        return [i for i in row_cols if owner[i] == d]

    dev_edges = []
    for d in range(n_dev):
        j0 = d * cpd
        edges = [
            (int(e), int(lay.edge_col[e]) - j0 + halo,
             int(lay.edge_shift[e]), int(i))
            for i in device_rows(d)
            for e in lay.row_edges(i)
        ]
        assert all(0 <= c < cpd + halo for _, c, _, _ in edges)
        dev_edges.append(edges)
    max_edges = max(len(e) for e in dev_edges)

    right = [(d, d + 1) for d in range(n_dev - 1)]   # halo to the right
    left = [(d + 1, d) for d in range(n_dev - 1)]    # returns to the left

    def sharded_decode(llr):
        batch = llr.shape[0]
        L_full = llr.astype(jnp.float32).T.reshape(nb, Z, batch)

        def device_fn(L_loc):
            d = jax.lax.axis_index(axis)

            def local_pass(d_static):
                """Purely local CN pass + scatter for one device's rows:
                (P_ext, R (max_edges, Z, batch)) -> (C_ext, R_new, viol).
                No collectives in here (see module docstring)."""
                edges = dev_edges[d_static]
                rows: dict[int, list[int]] = {}
                for idx, (_, _, _, i) in enumerate(edges):
                    rows.setdefault(i, []).append(idx)

                def fn(P_ext, R):
                    C_ext = jnp.zeros_like(P_ext)
                    viol = jnp.zeros((1, batch), jnp.int32)
                    R_new = R
                    for i, idxs in rows.items():
                        qs, parity = [], None
                        for idx in idxs:
                            _, c, s, _ = edges[idx]
                            t = jnp.roll(P_ext[c], -s, axis=0)
                            b = t < 0
                            parity = b if parity is None else parity ^ b
                            qs.append(t - R[idx])
                        viol = viol + jnp.sum(
                            parity.astype(jnp.int32), axis=0, keepdims=True)
                        outs = (cn_update(qs, alpha, beta)
                                if algo == "minsum" else cn_update(qs))
                        for idx, r_new in zip(idxs, outs):
                            _, c, s, _ = edges[idx]
                            R_new = R_new.at[idx].set(r_new)
                            C_ext = C_ext.at[c].add(
                                jnp.roll(r_new, s, axis=0))
                    return C_ext, R_new, viol

                return fn

            branches = [local_pass(dd) for dd in range(n_dev)]

            def one_iter(P_loc, R):
                # collective 1 (top level): halo to the right neighbor
                halo_P = jax.lax.ppermute(P_loc[-halo:], axis, right)
                P_ext = jnp.concatenate([halo_P, P_loc], axis=0)
                C_ext, R_new, viol_loc = jax.lax.switch(
                    d, branches, P_ext, R)
                # collective 2: boundary contributions back to the left
                ret = jax.lax.ppermute(C_ext[:halo], axis, left)
                P_next = L_loc + C_ext[halo:]
                P_next = P_next.at[-halo:].add(ret)
                # collective 3: global violation count
                viol = jax.lax.psum(viol_loc, axis)
                return P_next, R_new, viol

            R0 = jnp.zeros((max_edges, Z, batch), jnp.float32)

            def body(it, carry):
                P_loc, R, done, iu = carry
                P_new, R_new, viol = one_iter(P_loc, R)
                ok_now = (viol == 0)[0]
                newly = ok_now & ~done
                iu = jnp.where(newly, it - 1, iu)
                done = done | ok_now
                keep = done[None, None, :]
                P_loc = jnp.where(keep, P_loc, P_new)
                R = jnp.where(keep, R, R_new)
                return P_loc, R, done, iu

            done0 = jnp.zeros(batch, bool)
            iu0 = jnp.full(batch, iters, jnp.int32)
            P_loc, R, done, iu = jax.lax.fori_loop(
                1, iters + 1, body, (L_loc, R0, done0, iu0))
            # final syndrome of the last posterior
            _, _, viol = one_iter(P_loc, R)
            ok_now = (viol == 0)[0]
            iu = jnp.where(ok_now & ~done, iters, iu)
            done = done | ok_now
            return P_loc, done, iu

        fn = shard_map(
            device_fn, mesh=mesh,
            in_specs=(P(axis),), out_specs=(P(axis), P(), P()),
            check_vma=False,
        )
        P_out, done, iu = fn(L_full)
        bits = (P_out.reshape(nb * Z, batch) < 0).astype(jnp.uint8).T
        return bits, done, iu

    return jax.jit(sharded_decode)
