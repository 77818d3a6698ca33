"""`python -m tpu_ldpc.sim` — alias for the sweep CLI (SURVEY.md L5)."""

from tpu_ldpc.cli.sim import entry

entry()
