"""Tanner layout compiler tests (SURVEY.md M2: the code<->kernel contract)."""

import numpy as np
import pytest

from tpu_ldpc.codes import LdpcCode, make_base_graph
from tpu_ldpc.codes.layout import compile_layout


@pytest.fixture(scope="module")
def code():
    return LdpcCode.judged()


def test_decompile_roundtrip(code):
    lay = compile_layout(code)
    assert np.array_equal(lay.decompile(), code.B)


def test_edge_order_row_major(code):
    lay = code.layout
    keys = list(zip(lay.edge_row.tolist(), lay.edge_col.tolist()))
    assert keys == sorted(keys)


def test_row_ptr_consistency(code):
    lay = code.layout
    for i in range(lay.mb):
        es = lay.row_edges(i)
        assert all(lay.edge_row[e] == i for e in es)
    assert lay.row_ptr[-1] == lay.E


def test_col_slots_ascending_rows(code):
    lay = code.layout
    for j in range(lay.nb):
        rows = [lay.edge_row[e] for e in lay.col_edges(j)]
        assert rows == sorted(rows)
        assert len(rows) == lay.col_deg[j]


def test_degrees_match_base(code):
    lay = code.layout
    B = code.B
    assert (lay.row_deg == (B >= 0).sum(axis=1)).all()
    assert (lay.col_deg == (B >= 0).sum(axis=0)).all()


def test_vmem_estimate_monotone(code):
    lay = code.layout
    assert lay.state_bytes(256) == 2 * lay.state_bytes(128)
    assert lay.state_bytes(128) > 0


def test_layout_frozen(code):
    lay = code.layout
    with pytest.raises(ValueError):
        lay.edge_shift[0] = 1
