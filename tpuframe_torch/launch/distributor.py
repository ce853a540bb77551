"""Distributor: spawn worker processes, inject the rendezvous env, collect
results.

Port of ``tpuframe/launch/distributor.py`` (TorchDistributor's surface):
``Distributor(num_processes=N).run(train_fn, *args, **kwargs)`` pickles
the function with cloudpickle (so closures work), starts N local python
workers (``python -m tpuframe_torch.launch._worker``) and returns rank 0's
picklable return value.  The first failing rank is the root cause: its
recorded exception is re-raised with a :class:`DistributorError` (rank,
exit code, stderr tail with its traceback) as ``__cause__``.

The worker env is the JAX launcher's contract: ``MASTER_ADDR`` /
``MASTER_PORT``, ``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE`` and the
``TPUFRAME_PROCESS_ID`` / ``TPUFRAME_NUM_PROCESSES`` pair for every
worker; the coordinator, the control-plane port and the run's token only
when there is more than one process.  ``core.initialize()`` in the worker
reads it: one process drives one device, ``cuda:LOCAL_RANK``, in an NCCL
group (a world of one included); more workers than cards share them in a
gloo group (``LOCAL_WORLD_SIZE``).

Liveness: with more than one process, a heartbeat monitor
(``core.native``) hears every worker's beacon; a rank whose beacon goes
silent while its process still looks alive (a frozen or lost host) fails
the run as :class:`WorkerLostError` within ``heartbeat_timeout_s``, not at
``timeout_s``.  The monitor is best-effort, as in JAX: when it cannot be
built, the run goes on without it and the launcher logs why.

``simulate_devices``: the JAX launcher gives each worker K virtual CPU
devices through an XLA flag.  torch has none, so in the port it is the
caller's request for CPU workers: ``simulate_devices=1`` puts
``TPUFRAME_SIMULATE_DEVICES=1`` in every worker's env, and
``core.resolve_device`` then takes the CPU where no device is named (gloo
groups, one device a process).  A value above 1 raises
``NotImplementedError``, as ``core.simulate_cpu_devices`` does: run K
processes of one device each instead.  Nothing else puts a worker on the
CPU.

Not yet: ``local_mode=False`` (remote hosts) raises, and waits for a
later slice (ROADMAP.md, Queue 1 item 9).  :class:`ZeroDistributor` hands
the train fn its ``zero_config=``.
"""

from __future__ import annotations

import logging
import os
import pickle
import secrets
import subprocess
import sys
import tempfile
import time
from typing import Any, Callable, Mapping, Sequence

from tpuframe_torch.core.runtime import SIMULATE_ENV, check_simulated_devices

__all__ = ["Distributor", "DistributorError", "WorkerLostError", "await_and_root_cause"]

log = logging.getLogger("tpuframe_torch.launch")

_STDERR_TAIL = 4000

#: the exit code of the launcher's own kill (SIGKILL), apart from crashes
_KILL_CODES = (-9,)

#: once one worker has failed, hung peers get this long to exit on their
#: own before the launcher kills them
_FAILURE_GRACE_S = 5.0


def _free_port() -> int:
    """A port bindable on all interfaces now."""
    import socket

    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _stale_rank_check(monitor, timeout_s):
    """A health check over a HeartbeatMonitor (None when there is none):
    the first still-pending rank whose beacon went silent becomes a
    :class:`WorkerLostError`.  Only pending ranks count: the beacon of a
    worker that exited cleanly goes silent too."""
    if monitor is None or not timeout_s:
        return None

    def check(pending_ranks):
        for r in monitor.stale_ranks(timeout_s):
            if r in pending_ranks:
                return WorkerLostError(r, monitor.ms_since(r) / 1000.0)
        return None

    return check


def await_and_root_cause(
    workers: Sequence[tuple[int, Any, Any]],
    *,
    deadline: float,
    timeout_s: float,
    make_failure: Callable[[int, int, Any], BaseException],
    kill_all: Callable[[], None],
    describe_timeout: Callable[[int], str],
    health_check: Callable[[set], BaseException | None] | None = None,
    poll_interval_s: float = 0.2,
) -> None:
    """The launchers' wait loop, as the JAX package's.

    ``workers`` are ``(rank, popen_like, extra)`` in rank order.  Polls
    every worker (a dead rank is seen within ``poll_interval_s`` whatever
    its rank) under the run-wide ``deadline``; once one has failed, hung
    peers get ``_FAILURE_GRACE_S``, not the rest of the deadline.
    ``health_check`` (heartbeat staleness) gets the pending ranks and may
    return an exception that declares one lost.  At the deadline,
    ``kill_all()``, then the first crashed peer (not one that ``kill_all``
    ended) is the root cause: one dead rank with the others hung at a
    collective is the usual shape.  Raises the best failure found, or
    :class:`TimeoutError`; returns when every worker succeeded.  (The JAX
    function's ``finished_check`` and ``self_inflicted`` serve its remote
    launcher alone, which the port does not have yet.)
    """
    pending: dict[int, tuple[Any, Any]] = {r: (p, e) for r, p, e in workers}
    failure: BaseException | None = None
    grace_deadline: float | None = None
    while pending:
        now = time.monotonic()
        cap = deadline if grace_deadline is None else min(deadline, grace_deadline)
        if now >= cap:
            break
        for rank in list(pending):
            p, extra = pending[rank]
            code = p.poll()
            if code is None:
                continue
            del pending[rank]
            if code != 0 and failure is None:
                failure = make_failure(rank, code, extra)
                grace_deadline = time.monotonic() + _FAILURE_GRACE_S
        if pending and failure is None and health_check is not None:
            lost = health_check(set(pending))
            if lost is not None:
                # the lost worker stays pending: kill_all reaps it
                failure = lost
                grace_deadline = time.monotonic() + _FAILURE_GRACE_S
        if pending:
            time.sleep(min(poll_interval_s, max(cap - time.monotonic(), 0.0)))
    if pending:
        kill_all()
        if failure is None:
            for rank, p, extra in workers:
                code = p.returncode
                if code in (None, 0) or code in _KILL_CODES:
                    continue
                failure = make_failure(rank, code, extra)
                break
        if failure is None:
            raise TimeoutError(describe_timeout(next(iter(pending)))) from None
    if failure is not None:
        raise failure


class DistributorError(RuntimeError):
    """A worker exited nonzero; carries its rank, exit code and stderr
    tail.  When the worker recorded its exception, ``run`` re-raises that
    exception instead, with this error as its ``__cause__``."""

    def __init__(self, rank: int, returncode: int, stderr_tail: str):
        self.rank = rank
        self.returncode = returncode
        self.stderr_tail = stderr_tail
        super().__init__(
            f"worker rank {rank} exited with code {returncode}\n"
            f"--- stderr tail ---\n{stderr_tail}")


class WorkerLostError(DistributorError):
    """A worker's liveness beacon went silent while its process still
    looked alive: a frozen or dead host, or a network partition."""

    def __init__(self, rank: int, silent_s: float):
        RuntimeError.__init__(
            self,
            f"worker rank {rank} lost: no heartbeat for {silent_s:.1f}s "
            "(process dead on its host, host down, or partitioned)")
        self.rank = rank
        self.returncode = None
        self.stderr_tail = ""
        self.silent_s = silent_s


class Distributor:
    """Spawn-and-collect launcher (≈ TorchDistributor).

    Args:
      num_processes: worker processes to spawn, one device each.
      local_mode: only True (local processes) is ported; False raises
        ``NotImplementedError``.
      hosts / connect / remote_kwargs: the remote mode's, refused with it.
      simulate_devices: 1 asks for CPU workers (module docstring); None
        (or 0) keeps them on the card; above 1 raises.
      env: extra env vars for every worker.
      master_port: rendezvous port (0 = pick a free one).
      timeout_s: the run's wall-clock cap.
      heartbeat_timeout_s: declare a rank lost (:class:`WorkerLostError`)
        when its beacon has been silent this long; None disables.

    After a run, ``heartbeat_active`` says whether the heartbeat monitor
    was built for it.
    """

    def __init__(
        self,
        num_processes: int = 1,
        *,
        local_mode: bool = True,
        hosts: Sequence[str] | None = None,
        connect: Callable[[str], list] | None = None,
        remote_kwargs: Mapping[str, Any] | None = None,
        simulate_devices: int | None = None,
        env: Mapping[str, str] | None = None,
        master_port: int = 0,
        timeout_s: float = 600.0,
        heartbeat_timeout_s: float | None = 15.0,
    ):
        if num_processes < 1:
            raise ValueError("num_processes must be >= 1")
        if not local_mode or hosts:
            raise NotImplementedError(
                "Distributor(local_mode=False): remote hosts are not ported yet; they come "
                "with the platform planes (ROADMAP.md, Queue 1 item 9)")
        if remote_kwargs or connect is not None:
            raise ValueError("remote_kwargs and connect only apply with local_mode=False")
        if simulate_devices:
            check_simulated_devices(simulate_devices)
        self.num_processes = num_processes
        self.simulate_devices = simulate_devices
        self.extra_env = dict(env or {})
        self.master_port = master_port
        self.timeout_s = timeout_s
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.heartbeat_active: bool | None = None
        self._hb_port: int | None = None

    # -- env -----------------------------------------------------------------
    def _worker_env(self, rank: int, port: int) -> dict[str, str]:
        env = dict(os.environ)
        env.update(self.extra_env)
        # the driver's import path, so functions pickled by reference (from
        # a module, not __main__) resolve in the workers
        driver_path = [p for p in sys.path if p and os.path.isdir(p)]
        existing = env.get("PYTHONPATH", "")
        env["PYTHONPATH"] = os.pathsep.join(driver_path + ([existing] if existing else []))
        env.update(
            MASTER_ADDR="127.0.0.1",
            MASTER_PORT=str(port),
            RANK=str(rank),
            LOCAL_RANK=str(rank),
            LOCAL_WORLD_SIZE=str(self.num_processes),
            WORLD_SIZE=str(self.num_processes),
            TPUFRAME_NUM_PROCESSES=str(self.num_processes),
            TPUFRAME_PROCESS_ID=str(rank),
        )
        for name in ("TPUFRAME_COORDINATOR", "TPUFRAME_CP_PORT", "TPUFRAME_CP_TOKEN",
                     "TPUFRAME_HB_PORT", "TPUFRAME_HB_ADDR", SIMULATE_ENV):
            if name not in self.extra_env:
                env.pop(name, None)  # a parent's own contract must not leak in
        if self.num_processes > 1:
            env["TPUFRAME_COORDINATOR"] = f"127.0.0.1:{port}"
            env["TPUFRAME_CP_PORT"] = str(self._cp_port)
            # plain assignment: the monitor was built with this token
            env["TPUFRAME_CP_TOKEN"] = self._cp_token
        if self._hb_port:
            env["TPUFRAME_HB_PORT"] = str(self._hb_port)
            env["TPUFRAME_HB_ADDR"] = "127.0.0.1"
        if self.simulate_devices:
            env[SIMULATE_ENV] = str(self.simulate_devices)
        return env

    _free_port = staticmethod(_free_port)

    def _start_monitor(self):
        """The heartbeat monitor of a run of more than one process, or
        None (disabled, one process, or it could not be built: logged)."""
        if not self.heartbeat_timeout_s or self.num_processes <= 1:
            return None
        from tpuframe_torch.core import native

        try:
            self._hb_port = self._free_port()
            return native.HeartbeatMonitor(self._hb_port, self.num_processes,
                                           token=self._cp_token)
        except (RuntimeError, OSError) as e:
            log.warning("heartbeat monitor not built, the run goes on without liveness "
                        "detection: %s", e)
            self._hb_port = None
            return None

    # -- run -----------------------------------------------------------------
    def run(self, fn: Callable, *args: Any, **kwargs: Any) -> Any:
        """Run ``fn(*args, **kwargs)`` on every worker; return rank 0's
        result (it must be picklable)."""
        import cloudpickle

        port = self.master_port or self._free_port()
        self._cp_port = self._free_port()
        self._cp_token = (self.extra_env.get("TPUFRAME_CP_TOKEN")
                          or os.environ.get("TPUFRAME_CP_TOKEN") or secrets.token_hex(16))
        with tempfile.TemporaryDirectory(prefix="tpuframe_torch_launch_") as tmp:
            payload = os.path.join(tmp, "payload.pkl")
            with open(payload, "wb") as f:
                cloudpickle.dump((fn, args, kwargs), f)

            # made just before the try whose finally closes it
            monitor = self._start_monitor()
            self.heartbeat_active = monitor is not None
            procs: list[tuple[int, subprocess.Popen, str]] = []
            stderr_files = []
            deadline = time.monotonic() + self.timeout_s
            try:
                for rank in range(self.num_processes):
                    result_path = os.path.join(tmp, f"result_{rank}.pkl")
                    stderr_path = os.path.join(tmp, f"stderr_{rank}.log")
                    stderr_f = open(stderr_path, "wb")
                    stderr_files.append(stderr_f)
                    p = subprocess.Popen(
                        [sys.executable, "-m", "tpuframe_torch.launch._worker", payload,
                         result_path],
                        env=self._worker_env(rank, port),
                        stderr=stderr_f,
                        stdout=None if rank == 0 else subprocess.DEVNULL,
                    )
                    procs.append((rank, p, stderr_path))

                await_and_root_cause(
                    procs,
                    deadline=deadline,
                    timeout_s=self.timeout_s,
                    make_failure=lambda rank, code, stderr_path: (
                        self._worker_failure(rank, code, stderr_path, tmp)),
                    kill_all=lambda: self._kill_and_reap(procs),
                    describe_timeout=lambda rank: (
                        f"run exceeded {self.timeout_s}s (worker rank {rank} still running)"),
                    health_check=_stale_rank_check(monitor, self.heartbeat_timeout_s),
                )
            finally:
                # every exit path leaves no live or zombie worker behind
                self._kill_and_reap(procs)
                for f in stderr_files:
                    f.close()
                if monitor is not None:
                    monitor.close()
                self._hb_port = None

            with open(os.path.join(tmp, "result_0.pkl"), "rb") as f:
                outcome = pickle.load(f)
        if outcome["ok"]:
            return outcome["value"]
        raise outcome["error"]

    @staticmethod
    def _kill_and_reap(procs: Sequence[tuple[int, subprocess.Popen, str]]) -> None:
        for _, q, _ in procs:
            if q.poll() is None:
                q.kill()
        for _, q, _ in procs:
            try:
                q.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass

    def _worker_failure(self, rank: int, code: int, stderr_path: str,
                        tmp: str) -> BaseException:
        """The failure of a worker that exited nonzero: its own recorded
        exception with a stderr-tail :class:`DistributorError` as
        ``__cause__``, or the DistributorError alone."""
        with open(stderr_path, "rb") as f:
            tail = f.read()[-_STDERR_TAIL:].decode(errors="replace")
        launch_err = DistributorError(rank, code, tail)
        recorded = self._recorded_error(os.path.join(tmp, f"result_{rank}.pkl"))
        if recorded is not None:
            recorded.__cause__ = launch_err
            return recorded
        return launch_err

    @staticmethod
    def _recorded_error(result_path: str) -> BaseException | None:
        """The exception a failed worker pickled, if it can be read."""
        try:
            with open(result_path, "rb") as f:
                outcome = pickle.load(f)
        except (OSError, EOFError, pickle.UnpicklingError, AttributeError, ImportError):
            return None
        err = outcome.get("error") if not outcome.get("ok", True) else None
        return err if isinstance(err, BaseException) else None


class ZeroDistributor(Distributor):
    """A :class:`Distributor` that hands a ZeRO config to the train fn: it
    receives ``zero_config=`` (a ``tpuframe_torch.parallel.ZeroConfig``)
    and builds its ``ParallelPlan`` from it."""

    def __init__(self, *args: Any, zero_config: Any = None, **kwargs: Any):
        super().__init__(*args, **kwargs)
        self.zero_config = zero_config

    def run(self, fn: Callable, *args: Any, **kwargs: Any) -> Any:
        if self.zero_config is not None:
            kwargs = {**kwargs, "zero_config": self.zero_config}
        return super().run(fn, *args, **kwargs)
