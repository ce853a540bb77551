"""Worker entry: ``python -m tpuframe_torch.launch._worker payload.pkl result.pkl``.

Port of ``tpuframe/launch/_worker.py``.  Loads the cloudpickled ``(fn,
args, kwargs)``, runs it, and writes the outcome, value or exception, as
a pickle for the driver.  An exception is re-raised after it is recorded,
so the exit code stays nonzero (the driver shows the stderr tail either
way).

Spans: ``launch/worker_bootstrap`` (with a watchdog lease when
``TPUFRAME_WATCHDOG_S`` is on) around the watcher's install, the beacon's
start and the payload's load, ``launch/worker_run`` around the call.

The bootstrap installs the preemption watcher (SIGTERM) unless
``TPUFRAME_PREEMPT_SIGNALS=0``, so a SIGTERM becomes a flag the Trainer
turns into a last-chance snapshot and :class:`~tpuframe_torch.fault.
Preempted`.  A failed run's outcome frame is written first, then
``fault.preempt.reraise_for_exit``: ``Preempted`` exits
``PREEMPTED_EXIT`` (143), anything else re-raises (exit 1).
"""

from __future__ import annotations

import os
import pickle
import sys


def main(payload_path: str, result_path: str) -> None:
    import cloudpickle

    from tpuframe_torch.track.telemetry import get_telemetry

    tele = get_telemetry()
    with tele.span("launch/worker_bootstrap"), tele.guard("launch/worker_bootstrap"):
        # the watcher before the user fn: a SIGTERM during the run becomes a
        # last-chance snapshot and Preempted instead of an instant end
        if os.environ.get("TPUFRAME_PREEMPT_SIGNALS", "1") != "0":
            from tpuframe_torch.fault import preempt

            preempt.install()
        # the beacon before anything heavy: the driver should see this rank
        # alive while torch imports; its thread beats until the process ends
        from tpuframe_torch.core.native import maybe_start_beacon

        maybe_start_beacon()
        with open(payload_path, "rb") as f:
            fn, args, kwargs = cloudpickle.load(f)
    try:
        # a span only, no watchdog lease: the user fn runs unbounded
        with tele.span("launch/worker_run"):
            value = fn(*args, **kwargs)
        outcome = {"ok": True, "value": value}
    except BaseException as e:  # recorded, then re-raised
        try:
            cloudpickle.dumps(e)
            outcome = {"ok": False, "error": e}
        except Exception:
            outcome = {"ok": False, "error": RuntimeError(repr(e))}
        _write(result_path, outcome)
        # a distinguishable exit for policies that see only the process:
        # 143 when the platform took the machine, 1 when the code broke
        from tpuframe_torch.fault.preempt import reraise_for_exit

        reraise_for_exit(e)
    _write(result_path, outcome)


def _write(path: str, outcome: dict) -> None:
    # cloudpickle, as the payload: values and exceptions of classes defined
    # in a __main__ ship by value
    import cloudpickle

    try:
        with open(path, "wb") as f:
            cloudpickle.dump(outcome, f)
    except Exception as e:  # an unpicklable return value
        with open(path, "wb") as f:
            pickle.dump({"ok": False, "error": RuntimeError(f"result not picklable: {e}")}, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
