"""Worker entry: ``python -m tpuframe_torch.launch._worker payload.pkl result.pkl``.

Port of ``tpuframe/launch/_worker.py``.  Loads the cloudpickled ``(fn,
args, kwargs)``, runs it, and writes the outcome, value or exception, as
a pickle for the driver.  An exception is re-raised after it is recorded,
so the exit code stays nonzero (the driver shows the stderr tail either
way).

Spans: ``launch/worker_bootstrap`` (with a watchdog lease when
``TPUFRAME_WATCHDOG_S`` is on) around the beacon's start and the payload's
load, ``launch/worker_run`` around the call.

One difference from the JAX worker: it installs no preemption watcher
(``tpuframe.fault.preempt`` is not ported) and does not read
``TPUFRAME_PREEMPT_SIGNALS``.  Every failure is an exception re-raised as
it is, so the process exits 1 (a ``SystemExit`` with its own code); a
SIGTERM ends the worker as the signal does, where the JAX worker turns
it into ``Preempted`` and exits 143.
"""

from __future__ import annotations

import pickle
import sys


def main(payload_path: str, result_path: str) -> None:
    import cloudpickle

    from tpuframe_torch.track.telemetry import get_telemetry

    tele = get_telemetry()
    with tele.span("launch/worker_bootstrap"), tele.guard("launch/worker_bootstrap"):
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
        raise
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
