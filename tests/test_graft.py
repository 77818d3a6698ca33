"""Regression tests for __graft_entry__.py (VERDICT r3 missing #4).

entry() (single-device compile check) and dryrun_multichip(N)
(virtual-device sharded step) are an interface nothing else in the repo
exercises; it broke once (r1 stale signature).  These tests keep it
green in the default CPU suite.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def graft():
    spec = importlib.util.spec_from_file_location(
        "__graft_entry__", os.path.join(REPO, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_smoke_decode(graft):
    """entry() returns a callable + example args that decode on CPU."""
    import jax

    fn, args = graft.entry()
    (llr,) = args
    assert llr.dtype == np.float32 and llr.ndim == 2
    bits, ok, iu = jax.device_get(fn(*args))
    batch, n = llr.shape
    assert bits.shape == (batch, n)
    assert ok.shape == (batch,)
    assert iu.shape == (batch,)


def test_dryrun_multichip_2_and_twophase_pinned(graft, monkeypatch):
    """dryrun_multichip(2) compiles + executes on 2 virtual devices,
    AND its twophase stage passes interpret=True: the kernel runs on
    the CPU devices only in the Pallas interpreter, and nothing turns
    that on by itself.  One combined test so the ~25 s dryrun runs once
    in the default suite."""
    import tpu_ldpc.decode.twophase as tpmod

    seen = {}
    real = tpmod.build_twophase_decoder

    def spy(*args, **kwargs):
        seen.update(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(tpmod, "build_twophase_decoder", spy)
    graft.dryrun_multichip(2)
    assert seen.get("interpret") is True, (
        "dryrun's twophase stage no longer pins interpret=True — it "
        f"would need a GPU (saw {seen})")
