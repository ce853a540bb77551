"""Run a function on N CPU ranks of the port, for the multi-rank tests.

``run_ranks(fn, world, tmp_path)`` spawns ``world`` processes.  Each sets
``RANK``, ``WORLD_SIZE`` and ``TPUFRAME_COORDINATOR=file://<tmp>/store``
(a ``FileStore`` rendezvous under the test's own directory, so files that
run at once never share a port), calls ``fn(rank, world, *args)`` (which
joins the gloo group through ``tpuframe_torch.core.initialize``), and
returns what each rank returned.  The process group is always destroyed;
a rank that raises fails the call with its traceback; a run past
``timeout`` seconds is killed and fails, so a hung rendezvous cannot eat
the suite's time.

``fn`` must be a module-level function of a module the children can
import without JAX (the JAX side of a test stays in the parent).
"""

from __future__ import annotations

import os
import pickle
import time
import traceback
from pathlib import Path

import torch
import torch.multiprocessing as mp


def _child(rank: int, world: int, tmp: str, fn, args: tuple) -> None:
    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world),
                       "TPUFRAME_COORDINATOR": f"file://{tmp}/store"})
    for name in ("MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK", "TPUFRAME_PROCESS_ID",
                 "TPUFRAME_NUM_PROCESSES"):
        os.environ.pop(name, None)
    torch.set_num_threads(2)
    out = Path(tmp) / f"rank{rank}"
    try:
        from tpuframe_torch.core import shutdown

        try:
            result = fn(rank, world, *args)
        finally:
            shutdown()
        out.with_suffix(".pkl").write_bytes(pickle.dumps(result))
    except BaseException:
        out.with_suffix(".err").write_text(traceback.format_exc())
        raise SystemExit(1)


def run_ranks(fn, world: int, tmp_path, *args, timeout: float = 240.0) -> list:
    """``[fn(rank, world, *args) for rank in range(world)]``, each on its own
    process in one gloo group."""
    tmp = Path(tmp_path) / "ranks"
    tmp.mkdir(parents=True, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(r, world, str(tmp), fn, args), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        if hung:
            raise TimeoutError(f"ranks {hung} still running after {timeout} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    errors = {r: (tmp / f"rank{r}.err") for r in range(world)}
    failed = {r: e.read_text() for r, e in errors.items() if e.exists()}
    if failed or any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"ranks failed (exit codes {[p.exitcode for p in procs]}):\n"
                           + "\n".join(f"-- rank {r}:\n{t}" for r, t in failed.items()))
    return [pickle.loads((tmp / f"rank{r}.pkl").read_bytes()) for r in range(world)]
