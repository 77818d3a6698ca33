"""Encoders: generator matmul + dual-diagonal back-substitution (L1)."""

from tpu_ldpc.encode.encoder import build_encoder, encode  # noqa: F401
