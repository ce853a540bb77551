"""Per-host launch agent: ``python -m tpuframe_torch.launch.agent``.

Port of ``tpuframe/launch/agent.py``: the remote half of
:class:`tpuframe_torch.launch.RemoteDistributor`.  One agent runs per rank
on its host and executes the shipped train fn as that rank.

Protocol (the JAX package's, over any transport that can exec a command
and pipe its stdio: ssh, ``kubectl exec``, ``docker exec`` or a bare
subprocess):

- **stdin**: one JSON header line ``{"payload_bytes": N, "env": {...}}``
  followed by exactly ``N`` bytes of cloudpickled ``(fn, args, kwargs)``.
- **stdout**: the fn's own stdout passes through untouched; the agent's
  last line is ``TPUFRAME_RESULT <base64(cloudpickle(outcome))>``, where
  ``outcome`` is ``{"ok": True, "value": ...}`` or ``{"ok": False,
  "error": exc}``.
- **stderr**: passes through (the driver keeps a tail a rank).
- **exit code**: 0 on success, nonzero on failure (143 for
  :class:`~tpuframe_torch.fault.Preempted`, through
  ``fault.preempt.reraise_for_exit``); the result frame still carries the
  typed exception when it pickles, so restart policies dispatch on its
  type.

The env contract (``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/...) arrives in
the header and is applied to ``os.environ`` before the payload is
unpickled; the header's ``PYTHONPATH`` also lands on ``sys.path`` so
functions pickled by reference resolve.  Variables that must exist before
the interpreter starts (``PYTHONPYCACHEPREFIX``, say) belong in the
transport's command or its environment, not the header.

Once the payload is read, the agent arms the orphan watchdog (stdin EOF:
exit :data:`ORPHANED_EXIT`), installs the preemption watcher unless
``TPUFRAME_PREEMPT_SIGNALS=0``, and starts the heartbeat beacon when
``TPUFRAME_HB_PORT`` is set.  ``TPUFRAME_SIMULATE_DEVICES`` needs nothing
here: ``core.resolve_device`` reads it where no device is named (a value
above 1 raises there, as in the local launcher).
"""

from __future__ import annotations

import base64
import json
import os
import pickle
import sys
import threading

RESULT_SENTINEL = "TPUFRAME_RESULT "

#: exit code of the stdin-EOF watchdog (the driver or its transport is gone)
ORPHANED_EXIT = 17


def _arm_orphan_watchdog() -> None:
    """Exit when the driver disappears.

    The driver holds this agent's stdin open for the whole run.  Killing
    the local transport client (ssh) does not signal a remote command run
    without a pty, and an orphaned agent would keep training and hold the
    host's card; EOF on stdin is the one signal every stdio transport
    delivers on disconnect.
    """

    def watch() -> None:
        try:
            # a raw-fd read, not sys.stdin.buffer: a daemon thread blocked in
            # the buffered reader holds its lock through interpreter shutdown
            fd = sys.stdin.fileno()
            while os.read(fd, 4096):
                pass  # stray bytes after the payload: ignore, keep watching
        except (OSError, ValueError):  # stdin closed or detached: the driver is gone too
            pass
        os._exit(ORPHANED_EXIT)

    threading.Thread(target=watch, daemon=True, name="orphan-watchdog").start()


def _emit(outcome: dict) -> None:
    import cloudpickle

    try:
        blob = cloudpickle.dumps(outcome)
    except Exception as e:  # an unpicklable return value
        blob = pickle.dumps({"ok": False, "error": RuntimeError(f"result not picklable: {e}")})
    # the leading newline ends a partial stdout line the fn may have left
    sys.stdout.write("\n" + RESULT_SENTINEL + base64.b64encode(blob).decode() + "\n")
    sys.stdout.flush()


def main() -> None:
    header = json.loads(sys.stdin.buffer.readline())
    env = dict(header.get("env", {}))
    os.environ.update(env)
    if env.get("PYTHONPATH"):
        for p in reversed(env["PYTHONPATH"].split(os.pathsep)):
            if p and p not in sys.path:
                sys.path.insert(0, p)

    n = int(header["payload_bytes"])
    blob = sys.stdin.buffer.read(n)
    if len(blob) != n:
        _emit({"ok": False, "error": RuntimeError(f"truncated payload: got {len(blob)}/{n} bytes")})
        raise SystemExit(1)
    _arm_orphan_watchdog()

    # a SIGTERM to this agent (spot reclaim, a drain, a pod's grace period)
    # becomes the flag the Trainer turns into a last-chance snapshot and
    # Preempted
    if os.environ.get("TPUFRAME_PREEMPT_SIGNALS", "1") != "0":
        from tpuframe_torch.fault import preempt

        preempt.install()

    if env.get("TPUFRAME_HB_PORT"):
        from tpuframe_torch.core.native import maybe_start_beacon

        maybe_start_beacon()

    import cloudpickle

    fn, args, kwargs = cloudpickle.loads(blob)
    try:
        value = fn(*args, **kwargs)
    except BaseException as e:  # recorded in the frame, then re-raised
        try:
            cloudpickle.dumps(e)
            _emit({"ok": False, "error": e})
        except Exception:
            _emit({"ok": False, "error": RuntimeError(repr(e))})
        # a distinguishable exit (143) for a policy that sees only the
        # process: the platform took the machine, not a bug
        from tpuframe_torch.fault.preempt import reraise_for_exit

        reraise_for_exit(e)
    _emit({"ok": True, "value": value})


if __name__ == "__main__":
    main()
