"""tpu-ldpc: an accelerator-native QC-LDPC coding framework (JAX).

Brand-new design (not a port) matching the capability surface of the
C++ reference library `eovs/ldpc-lib` (see SURVEY.md; the reference
mount is empty, so parity is anchored to BASELINE.json's five configs):

- QC-LDPC code construction: base-graph registry, circulant lifting,
  girth-aware shift selection (``tpu_ldpc.codes``).
- Encoding: dual-diagonal back-substitution and dense-generator
  matmul paths (``tpu_ldpc.encode``).
- Decoding: sum-product and normalized/offset min-sum with flooding and
  layered schedules and syndrome-checked early termination, as a fused
  Pallas (Triton) GPU kernel plus an XLA-compiled jnp path
  (``tpu_ldpc.decode``); ``tpu_ldpc.backend`` picks between them.
- BPSK/AWGN Monte-Carlo BER/FER harness (``tpu_ldpc.sim``), sharded over
  multi-device, multi-host meshes with psum-reduced counters
  (``tpu_ldpc.dist``).
- float64/float32 NumPy golden model used as ground truth by all tests
  (``tpu_ldpc.golden``).
"""

__version__ = "0.1.0"

from tpu_ldpc.codes.code import LdpcCode  # noqa: F401
