"""Backend policy: the one place that reads which device JAX runs on.

It decides three things, each by an explicit rule:

  * which decoder implementation a (code, cfg) gets (`choose_decoder`):
    the fused GPU kernel (decode/pallas_bp.py) or the XLA-compiled jnp
    path (decode/reference.py), by the kernel's declared capability
    (algorithms, capacity) and the backend;
  * how many Monte-Carlo batches run per dispatch (`steps_per_call`);
  * where JAX keeps its persistent compile cache (`use_compile_cache`).

Measurement entry points call `require_gpu`: a benchmark that finds no
GPU fails instead of timing the CPU.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import subprocess

import jax

log = logging.getLogger(__name__)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")
# Batches per dispatch on the GPU.  Not measured yet: sized to keep host
# round trips off the device's critical path until a run_ber cell with
# its idle share says otherwise.
GPU_STEPS_PER_CALL = 8


def platform() -> str:
    return jax.default_backend()


def on_gpu() -> bool:
    return platform() == "gpu"


def require_gpu(what: str = "this measurement") -> None:
    """Raise unless JAX's default backend is a GPU (no CPU fallback)."""
    if not on_gpu():
        raise RuntimeError(f"{what} needs a GPU; JAX's backend is "
                           f"{platform()!r}")


def device_summary() -> dict:
    """The device as JAX reports it: platform, kind and count."""
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def gpu_name_and_power_limit() -> str:
    """`nvidia-smi`'s name and power limit of the card(s), read by a
    subprocess that stays off JAX; '' where nvidia-smi is absent."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.stdout.strip()


def steps_per_call() -> int:
    """Monte-Carlo batches per dispatch (sim/mc.py, dist/mesh.py)."""
    return GPU_STEPS_PER_CALL if on_gpu() else 1


def use_compile_cache() -> str:
    """Point JAX's persistent compile cache at JAX_COMPILATION_CACHE_DIR
    when it is set (JAX reads it itself), else at <repo>/.jax_cache, a
    fixed path so that later runs hit.  Returns the directory used.
    Called by the entry points (CLI, bench.py, chip_smoke.py), never on
    import."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    return path


@dataclasses.dataclass(frozen=True)
class DecoderChoice:
    impl: str    # 'pallas' (the GPU kernel) or 'jnp' (the XLA path)
    reason: str


def choose_decoder(code, cfg) -> DecoderChoice:
    """Which single-pass soft decoder serves (code, cfg).

    impl='jnp' and impl='pallas' are honoured as asked (the kernel's
    builder refuses what it cannot run).  impl='auto' and the inner
    decoder of impl='twophase' take the kernel on a GPU when the kernel
    carries the algorithm, the code fits its capacity and no fixed-point
    mode is asked for; everything else takes the XLA path.
    """
    from tpu_ldpc.decode import pallas_bp

    impl = getattr(cfg, "impl", "auto")
    if impl in ("jnp", "pallas"):
        choice = DecoderChoice(impl, "requested")
    elif not on_gpu():
        choice = DecoderChoice("jnp", f"backend {platform()!r}: the "
                               "kernel runs only on a GPU")
    elif getattr(cfg, "quant_bits", None) is not None:
        choice = DecoderChoice("jnp", "fixed-point modes are served by "
                               "the XLA path")
    elif cfg.algo not in pallas_bp.KERNEL_ALGOS:
        choice = DecoderChoice("jnp", f"algo {cfg.algo!r} is served by "
                               "the XLA path")
    elif not pallas_bp.fits(code):
        choice = DecoderChoice("jnp", "state over the kernel's capacity")
    else:
        choice = DecoderChoice("pallas", "GPU kernel")
    log.info("decoder for %s (%s, %s): %s (%s)", code.name, cfg.algo,
             getattr(cfg, "schedule", "flooding"), choice.impl,
             choice.reason)
    return choice
