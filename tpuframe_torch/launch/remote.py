"""RemoteDistributor: place rank-k workers on N hosts over an exec transport.

Port of ``tpuframe/launch/remote.py``.  The reference's launchers get
worker placement from a resident cluster runtime (Spark executors,
`01_torch_distributor/01_basic_torch_distributor.py:360-367`; Ray actors,
`05_ray/01_fashion_mnist_pytorch_ray.ipynb:cell-5`); hosts without one are
reached by exec: ssh, ``kubectl exec``, ``docker exec``.  This driver owns
that path:

- one :mod:`tpuframe_torch.launch.agent` a rank, started through a
  pluggable ``connect`` hook (an argv prefix; ssh with BatchMode by
  default),
- the torchrun-style env contract (``MASTER_ADDR``/``RANK``/``WORLD_SIZE``
  and the ``TPUFRAME_*`` launch keys) shipped in the agent's stdin header,
  with the driver's knobs (:func:`all_env_vars`),
- the train fn cloudpickled over stdin (no shared filesystem needed),
- each rank's stderr tail streamed back and attached to its failure,
- rank 0's picklable result returned to the caller: the same ``.run()``
  surface as the local :class:`~tpuframe_torch.launch.Distributor`.

Failures as in the local launcher: a worker's own typed exception re-raises
on the driver with a :class:`RemoteLaunchError` (host, rank, exit code,
stderr tail) as ``__cause__``; a run-wide deadline caps the launch, and
once one rank has failed its hung peers get a short grace.  A heartbeat
monitor hears every agent's beacon, so a worker that died behind a
transport that lingers (an ssh client left alive) is found by its silence.

One card a process: JAX runs one process a host, which drives all of that
host's chips, and gives every rank ``LOCAL_RANK=0``.  The port drives one
card a process, so a host named k times in ``hosts`` runs k ranks, which
get ``LOCAL_RANK`` 0..k-1 in the order of the host's repeats and
``LOCAL_WORLD_SIZE=k`` (1 for a host named once); ``core.initialize`` then
maps them onto the host's cards, with gloo where they outnumber them
(ROADMAP Queue 3 difference 30).  Every other key is the JAX launcher's.
"""

from __future__ import annotations

import base64
import json
import os
import pickle
import secrets
import shlex
import subprocess
import sys
import threading
import time
from collections import deque
from typing import Any, Callable, Mapping, Sequence

from tpuframe_torch.core.runtime import check_simulated_devices
from tpuframe_torch.launch.distributor import (
    _KILL_CODES,
    _STDERR_TAIL,
    DistributorError,
    _free_port,
    _stale_rank_check,
    _start_monitor,
    await_and_root_cause,
)

__all__ = ["LAUNCH_CONTRACT_ENV_DOMAINS", "LAUNCH_CONTRACT_ENV_VARS", "RemoteDistributor",
           "RemoteLaunchError", "all_env_vars", "ssh_connect"]


class RemoteLaunchError(DistributorError):
    """A remote worker exited nonzero (or vanished) without a recoverable
    typed exception; carries its host, rank, exit code and stderr tail."""

    def __init__(self, host: str, rank: int, returncode: int, stderr_tail: str):
        self.host = host
        # not DistributorError.__init__: this message names the host
        RuntimeError.__init__(
            self, f"worker rank {rank} on host {host!r} exited with code {returncode}\n"
                  f"--- stderr tail ---\n{stderr_tail}")
        self.rank = rank
        self.returncode = returncode
        self.stderr_tail = stderr_tail


def ssh_connect(host: str) -> list[str]:
    """The default transport: non-interactive ssh (fails instead of
    prompting)."""
    return ["ssh", "-o", "BatchMode=yes", host]


#: the launch contract and host-local infrastructure: values the launcher
#: computes for each worker (rank, coordinator, control-plane ports and
#: token, host scratch) rather than copies from the driver's env, so not
#: part of :func:`all_env_vars`; the JAX package's list
LAUNCH_CONTRACT_ENV_VARS = (
    "TPUFRAME_PROCESS_ID",
    "TPUFRAME_NUM_PROCESSES",
    "TPUFRAME_COORDINATOR",
    "TPUFRAME_CP_PORT",
    "TPUFRAME_CP_TOKEN",
    "TPUFRAME_CP_BIND",
    "TPUFRAME_HB_PORT",
    "TPUFRAME_HB_ADDR",
    "TPUFRAME_SIMULATE_DEVICES",
    "TPUFRAME_RESULT_DIR",
    "TPUFRAME_LOCAL_SCRATCH",
    "TPUFRAME_NATIVE_KEEP_BUILDS",
)

#: value domains of the launch contract, as the JAX package declares them
#: (all "restart": a worker's identity is fixed at its spawn)
LAUNCH_CONTRACT_ENV_DOMAINS = {
    "TPUFRAME_PROCESS_ID": {"type": "int", "range": (0, None), "apply": "restart"},
    "TPUFRAME_NUM_PROCESSES": {"type": "int", "range": (1, None), "apply": "restart"},
    "TPUFRAME_COORDINATOR": {"type": "str", "apply": "restart"},
    "TPUFRAME_CP_PORT": {"type": "int", "range": (1, 65535), "apply": "restart"},
    "TPUFRAME_CP_TOKEN": {"type": "str", "apply": "restart"},
    "TPUFRAME_CP_BIND": {"type": "str", "apply": "restart"},
    "TPUFRAME_HB_PORT": {"type": "int", "range": (1, 65535), "apply": "restart"},
    "TPUFRAME_HB_ADDR": {"type": "str", "apply": "restart"},
    "TPUFRAME_SIMULATE_DEVICES": {"type": "int", "range": (0, None), "apply": "restart"},
    "TPUFRAME_RESULT_DIR": {"type": "path", "apply": "restart"},
    "TPUFRAME_LOCAL_SCRATCH": {"type": "path", "apply": "restart"},
    "TPUFRAME_NATIVE_KEEP_BUILDS": {"type": "int", "range": (0, None), "apply": "restart"},
}


def all_env_vars() -> tuple[str, ...]:
    """Every knob list of the port, aggregated: what the remote launcher
    ships from the driver's env to every host.

    Each list sits beside its knobs, in a module that imports no torch:
    ``track.telemetry.OBSERVABILITY_ENV_VARS``, ``fault.health.
    HEALTH_ENV_VARS``, ``serve.admission.SERVE_ENV_VARS``,
    ``core.workspace.PERF_ENV_VARS``, ``parallel.comms_env.COMMS_ENV_VARS``
    and ``track.system_metrics.MEMORY_ENV_VARS``.  It is the JAX package's
    aggregate less the knobs the port reads nowhere: those of modules it
    does not have yet (the compile cache, the kernel ledger, autotune,
    device time, the memory plane's other two, the serving fleet and
    router, straggler analysis) and the ones its design drops (the
    Pallas-only ``TPUFRAME_COMMS_ASYNC`` and ``TPUFRAME_COMMS_FUSED_BLOCK``,
    the telemetry file's rotation).
    """
    from tpuframe_torch.core.workspace import PERF_ENV_VARS
    from tpuframe_torch.fault.health import HEALTH_ENV_VARS
    from tpuframe_torch.parallel.comms_env import COMMS_ENV_VARS
    from tpuframe_torch.serve.admission import SERVE_ENV_VARS
    from tpuframe_torch.track.system_metrics import MEMORY_ENV_VARS
    from tpuframe_torch.track.telemetry import OBSERVABILITY_ENV_VARS

    return (OBSERVABILITY_ENV_VARS + HEALTH_ENV_VARS + SERVE_ENV_VARS + PERF_ENV_VARS
            + COMMS_ENV_VARS + MEMORY_ENV_VARS)


class _Worker:
    """One spawned agent: its process, the stdio pump threads, its outcome."""

    def __init__(self, rank: int, host: str, proc: subprocess.Popen, payload: bytes,
                 header: bytes, echo_stdout: bool):
        self.rank = rank
        self.host = host
        self.proc = proc
        self.outcome: dict | None = None
        self.frame_error: Exception | None = None
        self.stderr_tail: deque[bytes] = deque(maxlen=200)
        self._threads = [
            threading.Thread(target=self._pump_stdin, args=(header, payload), daemon=True),
            threading.Thread(target=self._pump_stdout, args=(echo_stdout,), daemon=True),
            threading.Thread(target=self._pump_stderr, daemon=True),
        ]
        for t in self._threads:
            t.start()

    def _pump_stdin(self, header: bytes, payload: bytes) -> None:
        try:
            self.proc.stdin.write(header)
            self.proc.stdin.write(payload)
            self.proc.stdin.flush()
            # stdin stays open: it is the agent's death watch (EOF: the
            # driver is gone, exit)
        except (BrokenPipeError, OSError):
            pass  # the agent died before reading; its exit code tells why

    def close_stdin(self) -> None:
        try:
            self.proc.stdin.close()
        except OSError:
            pass

    def _pump_stdout(self, echo: bool) -> None:
        from tpuframe_torch.launch.agent import RESULT_SENTINEL

        sentinel = RESULT_SENTINEL.encode()
        for line in self.proc.stdout:
            if line.startswith(sentinel):
                try:
                    self.outcome = pickle.loads(base64.b64decode(line[len(sentinel):].strip()))
                except Exception as e:  # a torn frame (killed mid-write)
                    self.frame_error = e
            elif echo:
                sys.stdout.write(f"[{self.host}:{self.rank}] {line.decode(errors='replace')}")
        self.proc.stdout.close()

    def _pump_stderr(self) -> None:
        for line in self.proc.stderr:
            self.stderr_tail.append(line)
        self.proc.stderr.close()

    def tail(self) -> str:
        return b"".join(self.stderr_tail)[-_STDERR_TAIL:].decode(errors="replace")

    def join_pumps(self, timeout: float = 5.0) -> None:
        for t in self._threads:
            t.join(timeout)


class RemoteDistributor:
    """``.run(fn, *args, **kwargs)`` across hosts; returns rank 0's result.

    Args:
      hosts: one entry a rank.  Entries are whatever ``connect``
        understands: DNS names for ssh, pod names for ``kubectl exec``.  A
        host named k times runs k ranks, one card each (module docstring).
      connect: ``host -> argv prefix`` (default: ssh BatchMode).  ``[]``
        execs locally: two "hosts" on localhost, or a custom launch fabric.
      remote_python: the python executable on the hosts (``python3``).
      master_addr: the coordinator's address as the hosts reach it
        (default ``hosts[0]``); ``MASTER_ADDR`` and the control plane's hub.
      master_port / cp_port: rendezvous ports (0: free ones picked here,
        right only when the driver shares the hosts' network, as on
        localhost; real clusters pass fixed ports).
      env: extra env vars shipped to every worker (credentials, say).
      ship_pythonpath: also ship the driver's ``sys.path`` as PYTHONPATH,
        right for localhost and shared filesystems (default: only for
        transports that do not go through a shell).
      shell_quote: the transport re-parses the command through a remote
        shell (ssh does; ``env``, ``kubectl exec ... --`` and ``docker
        exec`` do not).  Default: only for the built-in ssh transport.
      simulate_devices: 1 puts the workers on the CPU
        (``TPUFRAME_SIMULATE_DEVICES``); above 1 raises
        ``NotImplementedError``, as in the local launcher.
      stream_output: echo every worker's stdout, prefixed ``[host:rank]``
        (rank 0's always streams).
      timeout_s: the run-wide wall-clock cap.
      heartbeat_timeout_s: a rank whose beacon is silent this long is lost
        (:class:`~tpuframe_torch.launch.WorkerLostError`); None disables.
      driver_addr / hb_port: where the beacons reach the driver's monitor
        (default: ``master_addr``, a free port).

    After a run, ``heartbeat_active`` says whether the monitor was built.
    """

    def __init__(
        self,
        hosts: Sequence[str],
        *,
        connect: Callable[[str], list[str]] | None = None,
        remote_python: str = "python3",
        master_addr: str | None = None,
        master_port: int = 0,
        cp_port: int = 0,
        env: Mapping[str, str] | None = None,
        ship_pythonpath: bool | None = None,
        shell_quote: bool | None = None,
        simulate_devices: int | None = None,
        stream_output: bool = False,
        timeout_s: float = 600.0,
        heartbeat_timeout_s: float | None = 15.0,
        driver_addr: str | None = None,
        hb_port: int = 0,
    ):
        if not hosts:
            raise ValueError("hosts must be non-empty")
        if simulate_devices:
            check_simulated_devices(simulate_devices)
        self.hosts = list(hosts)
        self.connect = connect or ssh_connect
        self.shell_quote = self.connect is ssh_connect if shell_quote is None else shell_quote
        self.remote_python = remote_python
        self.master_addr = master_addr
        self.master_port = master_port
        self.cp_port = cp_port
        self.extra_env = dict(env or {})
        self.ship_pythonpath = ship_pythonpath
        self.simulate_devices = simulate_devices
        self.stream_output = stream_output
        self.timeout_s = timeout_s
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.driver_addr = driver_addr
        self.hb_port = hb_port
        self.heartbeat_active: bool | None = None

    # -- env -----------------------------------------------------------------
    def _local_ranks(self, rank: int) -> tuple[int, int]:
        """(``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``): the rank's place among
        the ranks of its host, and their number."""
        host = self.hosts[rank]
        return self.hosts[:rank].count(host), self.hosts.count(host)

    def _worker_env(self, rank: int, master: str, port: int, cp_port: int, token: str,
                    hb_port: int | None) -> dict[str, str]:
        world = len(self.hosts)
        env = dict(self.extra_env)
        # the driver's knobs reach every host (explicit env= entries win): a
        # remote worker starts from this header alone, and ranks that
        # disagree on a health threshold or a serve policy act apart
        for var in all_env_vars():
            if var in os.environ and var not in env:
                env[var] = os.environ[var]
        local_rank, local_world = self._local_ranks(rank)
        env.update(
            MASTER_ADDR=master,
            MASTER_PORT=str(port),
            RANK=str(rank),
            LOCAL_RANK=str(local_rank),  # one card a process (difference 30)
            LOCAL_WORLD_SIZE=str(local_world),
            WORLD_SIZE=str(world),
            TPUFRAME_NUM_PROCESSES=str(world),
            TPUFRAME_PROCESS_ID=str(rank),
        )
        if world > 1:
            env["TPUFRAME_COORDINATOR"] = f"{master}:{port}"
            env["TPUFRAME_CP_PORT"] = str(cp_port)
            # plain assignment: the monitor and the hub use this token
            env["TPUFRAME_CP_TOKEN"] = token
        if self.simulate_devices:
            env["TPUFRAME_SIMULATE_DEVICES"] = str(self.simulate_devices)
        if hb_port:
            env["TPUFRAME_HB_PORT"] = str(hb_port)
            env["TPUFRAME_HB_ADDR"] = self.driver_addr or master
        ship = self.ship_pythonpath
        if ship is None:
            ship = not self.shell_quote
        if ship:
            env["PYTHONPATH"] = os.pathsep.join(p for p in sys.path if p and os.path.isdir(p))
        return env

    _free_port = staticmethod(_free_port)

    def _command(self, host: str) -> list[str]:
        prefix = list(self.connect(host))
        agent = [self.remote_python, "-u", "-m", "tpuframe_torch.launch.agent"]
        if self.shell_quote:
            # ssh-like transports re-parse the command through the remote
            # shell: quote it so the argv survives
            return prefix + [" ".join(shlex.quote(a) for a in agent)]
        return prefix + agent

    # -- run -----------------------------------------------------------------
    def run(self, fn: Callable, *args: Any, **kwargs: Any) -> Any:
        """Run ``fn(*args, **kwargs)`` as rank k on ``hosts[k]``; return rank
        0's picklable result."""
        import cloudpickle

        # imported here, not with this module: the package must not load
        # the agent, which runs as ``-m`` (runpy warns of a module already
        # imported)
        from tpuframe_torch.launch.agent import ORPHANED_EXIT

        world = len(self.hosts)
        master = self.master_addr or self.hosts[0]
        port = self.master_port or self._free_port()
        cp_port = self.cp_port or self._free_port()
        # an unguessable token of the run: the hub is reachable on the
        # cluster's network, and the token travels in the stdin header
        token = self.extra_env.get("TPUFRAME_CP_TOKEN") or secrets.token_hex(16)
        payload = cloudpickle.dumps((fn, args, kwargs))

        monitor, hb_port = _start_monitor(self.heartbeat_timeout_s, world, token, self.hb_port)
        self.heartbeat_active = monitor is not None
        workers: list[_Worker] = []
        deadline = time.monotonic() + self.timeout_s
        try:
            for rank, host in enumerate(self.hosts):
                header = json.dumps({
                    "payload_bytes": len(payload),
                    "env": self._worker_env(rank, master, port, cp_port, token, hb_port),
                }).encode() + b"\n"
                proc = subprocess.Popen(self._command(host), stdin=subprocess.PIPE,
                                        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
                workers.append(_Worker(rank, host, proc, payload, header,
                                       echo_stdout=self.stream_output or rank == 0))

            def make_failure(rank: int, code: int, w: _Worker) -> BaseException:
                w.join_pumps()
                return self._worker_failure(w, code)

            await_and_root_cause(
                [(w.rank, w.proc, w) for w in workers],
                deadline=deadline,
                timeout_s=self.timeout_s,
                make_failure=make_failure,
                kill_all=lambda: self._kill_and_reap(workers),
                describe_timeout=lambda rank: (
                    f"run exceeded {self.timeout_s}s (worker rank {rank} on "
                    f"{self.hosts[rank]!r} still running)"),
                # cleanup closes stdin first, so a hung agent may exit by its
                # orphan watchdog before the kill lands: not a root cause
                self_inflicted=(*_KILL_CODES, ORPHANED_EXIT),
                health_check=self._drained_aware_check(monitor, workers),
                # every pending rank's frame in hand (success or failure):
                # only transports linger, and the scan below raises a
                # delivered failure
                finished_check=lambda pending: all(workers[r].outcome is not None
                                                   for r in pending),
            )
            # a failure frame from a worker whose transport wedged gave no
            # nonzero exit: surface the real exception, not a timeout
            for w in workers:
                if w.outcome is not None and not w.outcome.get("ok", True):
                    raise self._worker_failure(w, w.proc.returncode or 0)
        finally:
            self._kill_and_reap(workers)
            for w in workers:
                w.join_pumps()
            if monitor is not None:
                monitor.close()

        w0 = workers[0]
        if w0.outcome is None and w0.frame_error is None:
            # a large frame may still be draining through the pump after
            # the process exited: give it time before calling it missing
            w0.join_pumps(timeout=60.0)
        if w0.outcome is None:
            missing = ("no result frame on stdout "
                       + (f"(frame error: {w0.frame_error})" if w0.frame_error else "") + "\n")
            raise RemoteLaunchError(w0.host, 0, w0.proc.returncode or 0, missing + w0.tail())
        if w0.outcome["ok"]:
            return w0.outcome["value"]
        raise w0.outcome["error"]

    def _drained_aware_check(self, monitor, workers: Sequence[_Worker]):
        """The heartbeat check without the ranks whose frame has arrived: a
        finished agent's beacon goes silent while its transport may still
        be draining a large frame; that rank succeeded, it did not vanish."""
        base = _stale_rank_check(monitor, self.heartbeat_timeout_s)
        if base is None:
            return None

        def check(pending_ranks):
            return base({r for r in pending_ranks if workers[r].outcome is None})

        return check

    @staticmethod
    def _kill_and_reap(workers: Sequence[_Worker]) -> None:
        # stdin first: where kill() reaches only the local client (ssh), the
        # EOF is what tells the remote agent to exit
        for w in workers:
            w.close_stdin()
        for w in workers:
            if w.proc.poll() is None:
                w.proc.kill()
        for w in workers:
            try:
                w.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass

    @staticmethod
    def _worker_failure(w: _Worker, code: int) -> BaseException:
        launch_err = RemoteLaunchError(w.host, w.rank, code, w.tail())
        outcome = w.outcome
        if outcome is not None and not outcome.get("ok", True):
            err = outcome.get("error")
            if isinstance(err, BaseException):
                err.__cause__ = launch_err
                return err
        return launch_err
