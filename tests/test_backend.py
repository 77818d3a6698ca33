"""The backend policy (tpu_ldpc/backend.py): decoder choice, Monte-Carlo
steps per dispatch and the compile-cache location, each by an explicit
rule."""

import jax
import pytest

from tpu_ldpc import backend
from tpu_ldpc.codes import LdpcCode, make_base_graph
from tpu_ldpc.decode import pallas_bp
from tpu_ldpc.sim.mc import DecodeCfg


@pytest.fixture()
def small_code():
    return LdpcCode.from_base_graph(make_base_graph(4, 8, 8, seed=3), 8)


def test_cpu_takes_the_xla_path(small_code):
    choice = backend.choose_decoder(small_code, DecodeCfg())
    assert choice.impl == "jnp"
    assert "GPU" in choice.reason


@pytest.mark.parametrize("cfg,impl,reason", [
    (DecodeCfg(), "pallas", "GPU kernel"),
    (DecodeCfg(schedule="layered", algo="sumproduct"), "pallas",
     "GPU kernel"),
    (DecodeCfg(impl="twophase"), "pallas", "GPU kernel"),
    (DecodeCfg(quant_bits=6), "jnp", "fixed-point"),
    (DecodeCfg(algo="sumproduct-fast"), "jnp", "sumproduct-fast"),
    (DecodeCfg(impl="jnp"), "jnp", "requested"),
    (DecodeCfg(impl="pallas", quant_bits=6), "pallas", "requested"),
])
def test_gpu_choice_by_rule(small_code, monkeypatch, cfg, impl, reason):
    """On a GPU the kernel serves what it carries; the rest is the XLA
    path's, and an explicit impl is honoured as asked."""
    monkeypatch.setattr(backend, "on_gpu", lambda: True)
    choice = backend.choose_decoder(small_code, cfg)
    assert choice.impl == impl
    assert reason in choice.reason


def test_capacity_routes_to_xla(monkeypatch):
    monkeypatch.setattr(backend, "on_gpu", lambda: True)
    big = LdpcCode.from_base_graph(make_base_graph(12, 24, 512, seed=3),
                                   512, "huge")
    assert not pallas_bp.fits(big)
    assert backend.choose_decoder(big, DecodeCfg()).impl == "jnp"


def test_choice_is_logged(small_code, caplog):
    with caplog.at_level("INFO", logger="tpu_ldpc.backend"):
        backend.choose_decoder(small_code, DecodeCfg())
    assert any("decoder for" in r.message for r in caplog.records)


def test_api_uses_the_choice(small_code, monkeypatch):
    """decode.api builds exactly what the policy chose."""
    from tpu_ldpc.decode import reference
    from tpu_ldpc.decode.api import build_decode_fn

    monkeypatch.setattr(reference, "build_decoder",
                        lambda code, **kw: "xla")
    assert build_decode_fn(small_code, DecodeCfg(iters=7)) == "xla"
    built = {}
    monkeypatch.setattr(backend, "on_gpu", lambda: True)
    monkeypatch.setattr(pallas_bp, "build_pallas_decoder",
                        lambda code, **kw: built.update(kw) or "kernel")
    assert build_decode_fn(small_code, DecodeCfg(iters=7)) == "kernel"
    assert built["iters"] == 7


def test_steps_per_call(monkeypatch):
    assert backend.steps_per_call() == 1
    monkeypatch.setattr(backend, "on_gpu", lambda: True)
    assert backend.steps_per_call() == backend.GPU_STEPS_PER_CALL


def test_require_gpu_refuses_cpu():
    with pytest.raises(RuntimeError, match="needs a GPU"):
        backend.require_gpu("x")


def test_compile_cache_env_honoured(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR, when set, is the cache: the policy
    sets no other directory in code."""
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert backend.use_compile_cache() == str(tmp_path)
    assert calls == []


def test_compile_cache_fixed_path(monkeypatch):
    """Unset, the cache goes to <repo>/.jax_cache: a fixed path, never
    under a temporary directory, a PID or a timestamp."""
    import os

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = backend.use_compile_cache()
    assert path == os.path.join(backend.REPO_ROOT, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]
    assert os.path.isfile(os.path.join(backend.REPO_ROOT, "bench.py"))
