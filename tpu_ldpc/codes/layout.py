"""Tanner layout compiler (SURVEY.md C3): the contract between "code"
and "kernel" — the most important interface in the repo.

Compiles a QC code's base matrix into frozen host-side arrays that fully
describe the Tanner graph in the edge order every decoder implementation
shares (edges sorted by (block_row, block_col)).  Kernel generators
consume ONLY this object (never construction logic); the golden/jnp
decoders follow the same edge order, which is what makes bit-exact
cross-checking possible.

All shifts/indices refer to the circulant convention of
tpu_ldpc/codes/expand.py: block (i, j, s) connects check r of block-row
i to variable (r + s) % Z of block-col j; gathering variable values into
check coordinates is roll(v, -s), scattering back is roll(r, +s).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TannerLayout:
    """Frozen device-ready description of a lifted Tanner graph."""

    Z: int
    mb: int
    nb: int
    E: int                     # number of base-graph edges (nonzero blocks)
    edge_row: np.ndarray       # (E,) int32 block-row of each edge
    edge_col: np.ndarray       # (E,) int32 block-col of each edge
    edge_shift: np.ndarray     # (E,) int32 circulant shift of each edge
    row_ptr: np.ndarray        # (mb+1,) int32; edges of row i: [ptr[i], ptr[i+1])
    col_slots: np.ndarray      # (nb, max_col_deg) int32 edge ids, asc. row order
    col_mask: np.ndarray       # (nb, max_col_deg) bool validity
    row_deg: np.ndarray        # (mb,) int32
    col_deg: np.ndarray        # (nb,) int32

    @property
    def n(self) -> int:
        return self.nb * self.Z

    @property
    def m(self) -> int:
        return self.mb * self.Z

    @property
    def max_row_deg(self) -> int:
        return int(self.row_deg.max())

    @property
    def max_col_deg(self) -> int:
        return int(self.col_deg.max())

    def row_edges(self, i: int) -> list[int]:
        return list(range(int(self.row_ptr[i]), int(self.row_ptr[i + 1])))

    def col_edges(self, j: int) -> list[int]:
        return [int(e) for e, v in zip(self.col_slots[j], self.col_mask[j]) if v]

    def state_bytes(self, tile: int, dtype_bytes: int = 4) -> int:
        """Decoder state the fused GPU kernel keeps in flight for a tile
        of `tile` codewords: messages R (E, Zp) plus posterior P and
        channel L (nb, Zp) each, with Z padded to the next power of two
        Zp (decode/pallas_bp.py)."""
        Zp = 1 << (self.Z - 1).bit_length()
        return (self.E + 2 * self.nb) * Zp * dtype_bytes * tile

    def decompile(self) -> np.ndarray:
        """Reconstruct the base matrix (inverse of compile_layout)."""
        B = np.full((self.mb, self.nb), -1, dtype=np.int64)
        for e in range(self.E):
            B[self.edge_row[e], self.edge_col[e]] = self.edge_shift[e]
        return B


def compile_layout(code) -> TannerLayout:
    """Compile an LdpcCode's base matrix into a TannerLayout."""
    B = np.asarray(code.B)
    Z = int(code.Z)
    mb, nb = B.shape
    rows, cols = np.nonzero(B >= 0)
    order = np.lexsort((cols, rows))  # sort by (row, col)
    rows, cols = rows[order], cols[order]
    shifts = B[rows, cols]
    E = len(rows)

    row_deg = np.bincount(rows, minlength=mb)
    col_deg = np.bincount(cols, minlength=nb)
    row_ptr = np.zeros(mb + 1, dtype=np.int32)
    np.cumsum(row_deg, out=row_ptr[1:])

    max_cd = int(col_deg.max())
    col_slots = np.zeros((nb, max_cd), dtype=np.int32)
    col_mask = np.zeros((nb, max_cd), dtype=bool)
    pos = np.zeros(nb, dtype=np.int64)
    for e in range(E):  # e ascending == ascending (row, col) == asc. row per col
        j = cols[e]
        col_slots[j, pos[j]] = e
        col_mask[j, pos[j]] = True
        pos[j] += 1

    layout = TannerLayout(
        Z=Z,
        mb=mb,
        nb=nb,
        E=E,
        edge_row=rows.astype(np.int32),
        edge_col=cols.astype(np.int32),
        edge_shift=shifts.astype(np.int32),
        row_ptr=row_ptr,
        col_slots=col_slots,
        col_mask=col_mask,
        row_deg=row_deg.astype(np.int32),
        col_deg=col_deg.astype(np.int32),
    )
    for arr in (
        layout.edge_row, layout.edge_col, layout.edge_shift, layout.row_ptr,
        layout.col_slots, layout.col_mask, layout.row_deg, layout.col_deg,
    ):
        arr.setflags(write=False)
    assert np.array_equal(layout.decompile(), B), "layout decompile mismatch"
    return layout
