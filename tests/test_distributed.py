"""Two-process jax.distributed sweep: counters must match single-process.

Spawns two real processes (4 virtual CPU devices each) wired through a
jax.distributed coordinator — the closest to a multi-host pod this
environment allows — and checks the psum'd counters equal a single-process
8-device run on the same keys.
"""

import os
import socket
import subprocess
import sys

import pytest

_CHILD = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 4)
pid = int(sys.argv[1]); port = sys.argv[2]
jax.distributed.initialize(
    coordinator_address=f"127.0.0.1:{port}", num_processes=2, process_id=pid)
from ldpcgputegra.ops.layered import LayeredSpec
from ldpcgputegra.sim.distributed import run_distributed_point
res = run_distributed_point(
    "576x288", 2.0, 64, 3, LayeredSpec(algo="OMS", iters=3), seed=5)
if res is not None:
    print(f"RESULT {res.frames} {res.bit_errors} {res.frame_errors}")
"""


@pytest.mark.slow
def test_two_process_distributed_matches_single():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = (
        os.path.dirname(os.path.dirname(__file__))
        + os.pathsep
        + env.get("PYTHONPATH", "")
    )
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _CHILD, str(pid), port],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, f"child failed:\n{err[-2000:]}"
        outs.append(out)
    result = [l for l in outs[0].splitlines() if l.startswith("RESULT")]
    assert result, f"no RESULT line in: {outs[0]}"
    frames, be, fe = map(int, result[0].split()[1:])

    # single-process reference on the 8-device mesh, same keys
    from ldpcgputegra.ops.layered import LayeredSpec
    from ldpcgputegra.sim.distributed import run_distributed_point

    ref = run_distributed_point(
        "576x288", 2.0, 64, 3, LayeredSpec(algo="OMS", iters=3), seed=5
    )
    assert (frames, be, fe) == (ref.frames, ref.bit_errors, ref.frame_errors)
