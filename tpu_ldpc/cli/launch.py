"""`python -m tpu_ldpc.cli.launch` — multi-host launcher (SURVEY.md §3.3).

Run the SAME command on every host; each process calls
`jax.distributed.initialize` (with the coordinator given by env, or
whatever the cluster's runtime discovers) and then executes the sweep
CLI with a global mesh.

    COORD=host0:1234 NPROC=4 PROC_ID=$i python -m tpu_ldpc.cli.launch \
        -- --family judged --ebn0 2.0 --mesh

Host 0 writes reports; all hosts make identical early-stop decisions
from the psum'd counters (replicated-control discipline).
"""

from __future__ import annotations

import os
import sys


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "--":
        argv = argv[1:]

    import jax

    kw = {}
    if os.environ.get("COORD"):
        kw = dict(
            coordinator_address=os.environ["COORD"],
            num_processes=int(os.environ["NPROC"]),
            process_id=int(os.environ["PROC_ID"]),
        )
    from tpu_ldpc.dist.mesh import init_distributed

    init_distributed(**kw)
    print(
        f"[launch] process {jax.process_index()}/{jax.process_count()}: "
        f"{len(jax.local_devices())} local / {len(jax.devices())} global "
        "devices",
        flush=True,
    )
    if "--mesh" not in argv:
        argv.append("--mesh")

    from tpu_ldpc import backend
    from tpu_ldpc.cli.sim import main as sim_main

    backend.use_compile_cache()
    return sim_main(argv)


if __name__ == "__main__":
    main()
