"""Decoder dispatch (SURVEY.md L2 public interface).

`decode(code, llrs, algo=..., iters=...) -> (bits, ok, iters_used)`.
Which implementation serves a (code, cfg) is the backend policy's rule
(tpu_ldpc/backend.py `choose_decoder`): the fused GPU kernel
(decode/pallas_bp.py) where it applies, else the XLA-compiled jnp
reference decoder.
"""

from __future__ import annotations

import jax.numpy as jnp

from tpu_ldpc import backend
from tpu_ldpc.codes.code import LdpcCode


def build_decode_fn(code: LdpcCode, cfg, mesh=None, mesh_axis: str = "tp"):
    """cfg: sim.mc.DecodeCfg (or anything with the same fields).

    mesh: optional jax.sharding.Mesh with a `mesh_axis` axis.  A code
    over the fused kernel's capacity (very long blocklengths) is then
    decoded across the mesh (dist/ring.py or dist/partitioned.py)
    instead of by the single-device XLA path (SURVEY.md §5 long-context
    row).
    """
    impl = getattr(cfg, "impl", "auto")
    # Quantization is only plumbed through the soft BP paths (minsum /
    # sumproduct family, flooding / layered).  Hard-decision decoders and
    # the windowed SC path ignore quant_* — reject rather than silently
    # report float FER labeled as quantized (ADVICE r1, medium).
    if getattr(cfg, "quant_bits", None) is not None and (
        cfg.algo in ("bitflip", "wbf")
        or getattr(cfg, "schedule", "flooding") == "windowed"
    ):
        raise ValueError(
            "quant_bits is not supported for hard-decision algos or the "
            "windowed schedule; it is only plumbed through the soft "
            "flooding/layered BP paths"
        )
    # window_sweep only means something inside the windowed schedule —
    # reject rather than silently run plain flooding labeled as a
    # layered-sweep result (same ignored-knob policy as quant_bits)
    if (getattr(cfg, "window_sweep", "flooding") != "flooding"
            and getattr(cfg, "schedule", "flooding") != "windowed"):
        raise ValueError(
            "window_sweep applies only to schedule='windowed'"
        )
    if cfg.algo in ("bitflip", "wbf"):
        # hard-decision decoders: integer-cheap, XLA-compiled jnp is
        # already at the memory floor (see decode/hard.py docstring)
        from tpu_ldpc.decode.hard import build_hard_decoder

        return build_hard_decoder(code, algo=cfg.algo, iters=cfg.iters)
    if getattr(cfg, "schedule", "flooding") == "windowed":
        # streaming SC-LDPC decoder (XLA scan; backend-agnostic).
        # cfg.iters counts iterations per window slide here.
        from tpu_ldpc.decode.windowed import build_windowed_decoder

        return build_windowed_decoder(
            code, window=cfg.window, iters_per_window=cfg.iters,
            algo=cfg.algo, alpha=cfg.alpha, beta=cfg.beta,
            sweep=getattr(cfg, "window_sweep", "flooding"),
        )
    # Long-blocklength routing: a code over the fused kernel's capacity
    # (decode/pallas_bp.py `fits`), given a mesh, is sharded over the
    # mesh: the ring for banded codes, else the row-striped partitioned
    # decoder (SURVEY §5 long-context row).
    from tpu_ldpc.decode import pallas_bp

    if (
        mesh is not None
        and impl == "auto"
        and getattr(cfg, "quant_bits", None) is None
        and cfg.schedule == "flooding"
        and not pallas_bp.fits(code)
    ):
        from tpu_ldpc.dist.partitioned import build_partitioned_decoder
        from tpu_ldpc.dist.ring import build_ring_decoder, ring_supports

        dist_kw = dict(algo=cfg.algo, iters=cfg.iters, alpha=cfg.alpha,
                       beta=cfg.beta, axis=mesh_axis)
        if ring_supports(code, mesh.shape[mesh_axis]):
            return build_ring_decoder(code, mesh, **dist_kw)
        return build_partitioned_decoder(code, mesh, **dist_kw)
    quant_kw = dict(
        quant_bits=getattr(cfg, "quant_bits", None),
        quant_step=getattr(cfg, "quant_step", 0.5),
        quant_post_bits=getattr(cfg, "quant_post_bits", None),
    )
    choice = backend.choose_decoder(code, cfg)
    if impl == "twophase":
        # two-phase straggler-compaction ET (decode/twophase.py),
        # bit-identical to the single-pass ET decoder it is built on.
        # Unset knobs resolve from the cell's registry metadata or
        # rate-derived defaults (decode/knobs.py); resolved knobs get a
        # first-overflow warning, since a mis-sized budget costs ~2x via
        # the full-batch fallback.
        from tpu_ldpc.decode.knobs import resolve_twophase_knobs
        from tpu_ldpc.decode.twophase import build_twophase_decoder

        k, b, source = resolve_twophase_knobs(
            code, cfg.schedule,
            getattr(cfg, "phase1_iters", None),
            getattr(cfg, "compact_budget", None),
        )
        return build_twophase_decoder(
            code, iters=cfg.iters, phase1_iters=k, budget=b,
            warn_on_fallback=source != "explicit", impl=choice.impl,
            algo=cfg.algo, alpha=cfg.alpha, beta=cfg.beta,
            schedule=cfg.schedule,
            **(quant_kw if choice.impl == "jnp" else {}),
        )
    if choice.impl == "pallas":
        if quant_kw["quant_bits"] is not None:
            raise ValueError("the GPU kernel has no fixed-point mode; "
                             "impl='auto' or 'jnp' serves quant_bits")
        return pallas_bp.build_pallas_decoder(
            code, algo=cfg.algo, iters=cfg.iters, alpha=cfg.alpha,
            beta=cfg.beta, schedule=cfg.schedule,
        )
    from tpu_ldpc.decode.reference import build_decoder

    return build_decoder(
        code,
        algo=cfg.algo,
        iters=cfg.iters,
        alpha=cfg.alpha,
        beta=cfg.beta,
        schedule=cfg.schedule,
        **quant_kw,
    )


def decode(
    code: LdpcCode,
    llrs,
    algo: str = "minsum",
    iters: int = 50,
    alpha: float = 0.75,
    beta: float = 0.0,
    schedule: str = "flooding",
    impl: str = "auto",
    quant_bits: int | None = None,
    quant_step: float = 0.5,
    quant_post_bits: int | None = None,
):
    from tpu_ldpc.sim.mc import DecodeCfg

    cfg = DecodeCfg(
        algo=algo, iters=iters, alpha=alpha, beta=beta,
        schedule=schedule, impl=impl, quant_bits=quant_bits,
        quant_step=quant_step, quant_post_bits=quant_post_bits,
    )
    fn = build_decode_fn(code, cfg)
    return fn(jnp.asarray(llrs))
