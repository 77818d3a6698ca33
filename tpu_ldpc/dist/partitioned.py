"""Partitioned (intra-codeword) BP decoding over a device mesh — the
long-blocklength / "tensor-parallel" axis (SURVEY.md §2.2 TP/SP rows, §5
long-context analog, M7).

None of the judged configs need this (every registry code's message
state fits the GPU kernel's per-codeword capacity), so this module is
the documented scaling path plus a working shard_map prototype, tested
on the fake CPU mesh.  Codes over the fused kernel's capacity
(decode/pallas_bp.py `fits`) are routed here automatically when
the caller provides a mesh (decode/api.py), instead of falling back to
the single-device jnp decoder.

Two decompositions of one BP iteration:

1. **Row-striped (implemented here).**  Check rows are sharded over the
   mesh axis; each device owns the CN->VN messages R of its row stripe.
   The posterior P (nb x Z x batch) is replicated: after the local CN
   pass each device computes its stripe's scatter contribution
   sum_{e in stripe} roll(R_e, +s_e) and one `psum` rebuilds the full
   posterior everywhere.  Comm per iteration = one all-reduce of P —
   the natural TP shape when the graph is wide but the posterior is
   small.  Syndrome violations ride the same psum.

2. **Column-partitioned ring (dist/ring.py).**  Block columns sharded,
   state fully local, two neighbor `ppermute` halo exchanges per
   iteration — the ring-attention communication shape over ICI.  Exact
   for banded base graphs (SC-LDPC chains); this row-striped path is
   the general-H fallback.

SPMD discipline (the lax.switch collective landmine, CLAUDE.md): each
device's stripe does different *local* work (different edge sets), so
only the local CN pass lives inside `lax.switch`; its outputs are
padded to common shapes and BOTH collectives (`psum` of the partial
posterior and of the violation count) issue at the top level of the
loop body, where every device reaches them with the same channel ids.

Determinism note: the psum reassociates the VN accumulation, so results
are deterministic for a fixed mesh but not bit-exact vs the sequential
golden contract; tests assert syndrome-valid outputs and near-total
frame agreement instead.
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


@functools.lru_cache(maxsize=16)
def build_partitioned_decoder(
    code: LdpcCode,
    mesh: Mesh,
    algo: str = "minsum",
    iters: int = 50,
    alpha: float = 0.75,
    beta: float = 0.0,
    axis: str = "tp",
):
    """Row-striped TP decoder: llr (batch, n) -> (bits, ok, iters_used).

    Requires mesh.shape[axis] <= mb (each device gets >= 1 block-row).
    """
    lay = code.layout
    Z, mb, nb = lay.Z, lay.mb, lay.nb
    n_dev = mesh.shape[axis]
    if n_dev > mb:
        raise ValueError(f"{n_dev} devices > {mb} block rows")
    # contiguous row stripes, sizes differing by <= 1
    stripe_bounds = np.linspace(0, mb, n_dev + 1).astype(int)
    # per-stripe edge lists (static)
    stripes = [
        [
            (int(e), int(lay.edge_col[e]), int(lay.edge_shift[e]), int(i))
            for i in range(stripe_bounds[d], stripe_bounds[d + 1])
            for e in lay.row_edges(i)
        ]
        for d in range(n_dev)
    ]
    max_edges = max(len(s) for s in stripes)
    if algo == "minsum":
        def cn_update(qs):
            return _cn_minsum(qs, alpha, beta)
    elif algo == "sumproduct-fast":
        cn_update = _cn_sumproduct_fast
    elif algo == "sumproduct":
        cn_update = _cn_sumproduct
    else:
        raise ValueError(f"unknown algo {algo!r}")

    def local_iteration(d, P_full, R_local, L):
        """One local CN pass + scatter for stripe d.

        R_local: (max_edges, Z, batch) padded stripe messages.
        Returns (partial_P, R_new_padded, viol) — common shapes across
        stripes so the collectives can issue OUTSIDE the stripe switch.
        """
        edges = stripes[d]
        rows: dict[int, list[int]] = {}
        for idx, (_, _, _, i) in enumerate(edges):
            rows.setdefault(i, []).append(idx)
        partial = jnp.zeros_like(L)
        viol = jnp.zeros((1,) + L.shape[-1:], jnp.int32)
        R_new = R_local
        for i, idxs in rows.items():
            qs, parity = [], None
            for idx in idxs:
                _, j, s, _ = edges[idx]
                t = jnp.roll(P_full[j], -s, axis=0)
                b = t < 0
                parity = b if parity is None else parity ^ b
                qs.append(t - R_local[idx])
            viol = viol + jnp.sum(parity.astype(jnp.int32), axis=0,
                                  keepdims=True)
            for idx, r_new in zip(idxs, cn_update(qs)):
                _, j, s, _ = edges[idx]
                R_new = R_new.at[idx].set(r_new)
                partial = partial.at[j].add(jnp.roll(r_new, s, axis=0))
        return partial, R_new, viol

    def sharded_decode(llr):
        batch = llr.shape[0]
        L_full = llr.astype(jnp.float32).T.reshape(nb, Z, batch)

        def device_fn(L):
            d = jax.lax.axis_index(axis)

            def local(P_full, R):
                # stripe-specific LOCAL work only — no collectives in
                # the branches (per-branch channel ids deadlock the
                # mesh); outputs are common-shaped
                return jax.lax.switch(
                    d,
                    [functools.partial(local_iteration, dd)
                     for dd in range(n_dev)],
                    P_full, R, L,
                )

            def body(it, carry):
                P_full, R, done, iu = carry
                partial, R_new, viol_loc = local(P_full, R)
                # collectives at the top level of the loop body
                viol = jax.lax.psum(viol_loc, axis)
                P_next = L + jax.lax.psum(partial, axis)
                ok_now = (viol == 0)[0]
                newly = ok_now & ~done
                iu = jnp.where(newly, it - 1, iu)
                done = done | ok_now
                keep = done[None, None, :]
                P_full = jnp.where(keep, P_full, P_next)
                R = jnp.where(keep, R, R_new)
                return P_full, R, done, iu

            R0 = jnp.zeros((max_edges, Z, batch), jnp.float32)
            done0 = jnp.zeros(batch, bool)
            iu0 = jnp.full(batch, iters, jnp.int32)
            P_full, R, done, iu = jax.lax.fori_loop(
                1, iters + 1, body, (L, R0, done0, iu0)
            )
            # final syndrome of the last posterior
            _, _, viol_loc = local(P_full, R)
            viol = jax.lax.psum(viol_loc, axis)
            ok_now = (viol == 0)[0]
            newly = ok_now & ~done
            iu = jnp.where(newly, iters, iu)
            done = done | ok_now
            return P_full, done, iu

        fn = shard_map(
            device_fn, mesh=mesh, in_specs=(P(),), out_specs=P(),
            check_vma=False,
        )
        P_full, done, iu = fn(L_full)
        bits = (P_full.reshape(nb * Z, batch) < 0).astype(jnp.uint8).T
        return bits, done, iu

    return jax.jit(sharded_decode)
