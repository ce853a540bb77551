"""Checkpoint directory reads and filesystem surgery: the stdlib half.

Port of ``tpuframe/ckpt/meta.py``, name for name.  Everything here works
off the on-disk layout alone, which the port shares with the JAX package:
digit-named step directories, a commit marker written as the last act of a
save, and the meta JSON at ``<dir>/<step>/meta/metadata`` with its
topology and health stamps.  From those: which steps committed, which are
torn, which are healthy, and the quarantine and rollback moves made before
a resume.  It imports neither torch nor the checkpoint writer, so the
readers keep working when the card or its runtime does not.  Either
package's readers read the other's directories; the tensor data of a step
is each package's own format.
"""

from __future__ import annotations

import json
import os

from tpuframe_torch.track.telemetry import get_telemetry

__all__ = [
    "COMMIT_MARKERS",
    "ckpt_health_verdict",
    "healthy_steps",
    "is_committed",
    "is_healthy",
    "latest_healthy_step",
    "latest_step",
    "quarantine_torn_steps",
    "read_health",
    "read_manifest",
    "rollback_to_last_healthy",
    "valid_steps",
]

#: Files whose presence marks a step directory as *committed*: a save
#: writes one as its last act (``_CHECKPOINT_METADATA``; the JAX package's
#: orbax writes ``commit_success.txt`` instead on filesystems without an
#: atomic rename).  A digit-named dir without one is torn: a save that died
#: between data write and commit.
COMMIT_MARKERS = ("_CHECKPOINT_METADATA", "commit_success.txt")


def is_committed(step_dir: str | os.PathLike) -> bool:
    """True iff ``step_dir`` carries a commit marker (a finished save)."""
    return any(
        os.path.exists(os.path.join(os.fspath(step_dir), m))
        for m in COMMIT_MARKERS
    )


def valid_steps(directory: str | os.PathLike) -> list[int]:
    """Sorted steps under ``directory`` whose saves actually committed.

    Torn dirs (kill between data write and commit) and in-flight
    ``*.orbax-checkpoint-tmp-*`` staging dirs (the name is the JAX
    package's; the port stages its saves the same way) are excluded:
    resuming from either crash-loops into corrupt state.
    """
    try:
        entries = os.listdir(directory)
    except (FileNotFoundError, NotADirectoryError):
        return []
    return sorted(
        int(e)
        for e in entries
        if e.isdigit() and is_committed(os.path.join(os.fspath(directory), e))
    )


def latest_step(directory: str | os.PathLike) -> int | None:
    """Highest *committed* step dir under ``directory`` (None if empty or
    missing).  Counting any digit-named dir — including torn/in-flight
    saves — would point auto-resume at unreadable state."""
    steps = valid_steps(directory)
    return steps[-1] if steps else None


def _quarantine_move(directory: str, entry: str) -> str:
    """Move ``<directory>/<entry>`` into ``<directory>/_quarantine/``
    (collision-suffixed — a step can be quarantined twice across
    restarts).  Moved aside, never deleted: quarantined state is
    evidence and may still be salvageable by hand."""
    src = os.path.join(directory, entry)
    qdir = os.path.join(directory, "_quarantine")
    os.makedirs(qdir, exist_ok=True)
    dst = os.path.join(qdir, entry)
    n = 0
    while os.path.exists(dst):
        n += 1
        dst = os.path.join(qdir, f"{entry}.{n}")
    os.rename(src, dst)
    return dst


def quarantine_torn_steps(directory: str | os.PathLike) -> list[str]:
    """Move torn step dirs into ``<directory>/_quarantine/`` (the
    supervisor's pre-resume validation).  Moved aside, never deleted:
    torn state is *evidence* (which leaves tore, how far the write got)
    and partially-written arrays may still be salvageable by hand.
    Returns the quarantined paths.  In-flight ``*-tmp-*`` dirs are left
    alone.  This can never race a live save on a filesystem with an atomic
    rename: ``ckpt.checkpoint`` stages the whole step in
    ``<step>.orbax-checkpoint-tmp-*`` and the digit dir appears only
    together with its commit marker, so a digit dir without one is torn.
    """
    directory = os.fspath(directory)
    try:
        entries = os.listdir(directory)
    except (FileNotFoundError, NotADirectoryError):
        return []
    moved: list[str] = []
    tele = get_telemetry()
    for e in entries:
        src = os.path.join(directory, e)
        if not (e.isdigit() and os.path.isdir(src)) or is_committed(src):
            continue
        dst = _quarantine_move(directory, e)
        moved.append(dst)
        tele.registry.counter("fault/quarantined_steps").inc()
        tele.event("fault/quarantine", step=int(e), src=src, dst=dst)
    return moved


def _read_meta_doc(directory: str | os.PathLike, step: int | None) -> dict | None:
    """The raw meta JSON doc of ``step`` (default: latest committed),
    read straight off disk (stdlib only)."""
    if step is None:
        step = latest_step(directory)
    if step is None:
        return None
    path = os.path.join(os.fspath(directory), str(step), "meta", "metadata")
    try:
        with open(path) as f:
            doc = json.load(f)
    except (FileNotFoundError, NotADirectoryError, IsADirectoryError, ValueError):
        return None
    return doc if isinstance(doc, dict) else None


def read_manifest(directory: str | os.PathLike, step: int | None = None) -> dict | None:
    """The topology manifest of ``step`` (default: latest committed), read
    straight off the on-disk meta JSON (stdlib only, no tensor read).  None
    for pre-manifest checkpoints or when no committed step exists."""
    doc = _read_meta_doc(directory, step)
    return doc.get("topology") if doc else None


def read_health(directory: str | os.PathLike, step: int | None = None) -> dict | None:
    """The training-health stamp of ``step`` (default: latest committed)
    — what the Trainer's sentinel wrote next to the topology manifest
    (loss EWMA, grad norm, bad-step count, ``healthy`` verdict).
    Stdlib-only like :func:`read_manifest`; None for pre-sentinel
    checkpoints or when no committed step exists."""
    doc = _read_meta_doc(directory, step)
    return doc.get("health") if doc else None


def ckpt_health_verdict(directory: str | os.PathLike,
                        step: int | None = None) -> tuple[bool, str]:
    """Strict health gate for promotion: ``(ok, reason)``.

    Unlike :func:`read_health` (tolerant — None for absent *and* corrupt,
    the right shape for the doctor) and :func:`is_healthy` (absent counts
    healthy, the right shape for rollback), a *promotion* gate must
    refuse on anything it cannot positively read: an uncommitted step, a
    truncated/garbage meta file, or a non-dict stamp is a loud "no", not
    a crash and not a silent pass.  A genuinely absent meta file on a
    committed step (pre-sentinel checkpoint) still passes — old-format
    history stays promotable, exactly like rollback treats it.
    """
    directory = os.fspath(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            return False, f"no committed checkpoint step under {directory}"
    step_dir = os.path.join(directory, str(step))
    if not is_committed(step_dir):
        return False, f"step {step} has no commit marker (torn save?)"
    path = os.path.join(step_dir, "meta", "metadata")
    try:
        with open(path) as f:
            doc = json.load(f)
    except FileNotFoundError:
        return True, f"step {step}: no meta stamp (pre-sentinel) — healthy"
    except (OSError, ValueError) as e:
        return False, f"step {step} meta unreadable ({e!r}) — refusing"
    if not isinstance(doc, dict):
        return False, f"step {step} meta is not a JSON object — refusing"
    health = doc.get("health")
    if health is None:
        return True, f"step {step}: no health stamp — healthy"
    if not isinstance(health, dict):
        return False, f"step {step} health stamp malformed — refusing"
    if not health.get("healthy", True):
        return False, f"step {step} stamped unhealthy by the sentinel"
    return True, f"step {step}: health stamp clean"


def is_healthy(directory: str | os.PathLike, step: int) -> bool:
    """True unless the step's health stamp explicitly says unhealthy —
    pre-sentinel checkpoints (no stamp) count healthy, so rollback never
    strands a run on old-format history."""
    stamp = read_health(directory, step)
    return bool((stamp or {}).get("healthy", True))


def healthy_steps(directory: str | os.PathLike) -> list[int]:
    """Committed steps whose health stamp is absent-or-healthy."""
    return [s for s in valid_steps(directory) if is_healthy(directory, s)]


def latest_healthy_step(directory: str | os.PathLike) -> int | None:
    """Newest committed step rollback may land on (None when every
    committed step is stamped unhealthy, or none exist)."""
    steps = healthy_steps(directory)
    return steps[-1] if steps else None


def rollback_to_last_healthy(directory: str | os.PathLike) -> dict:
    """Divergence rollback: quarantine every committed step NEWER than
    the newest *healthy* one, so plain auto-resume lands on known-good
    state instead of the newest (possibly poisoned) save.

    Steps are moved into ``<directory>/_quarantine/`` like torn steps —
    evidence, never deleted.  When no healthy step exists, every
    unhealthy-stamped step is quarantined (a fresh start beats resuming
    into a divergence).  Emits one loud ``fault/rollback`` event +
    ``fault/rollbacks`` counter when anything moved; a directory already
    at its healthy frontier is a silent no-op.  Returns
    ``{"to_step": int | None, "quarantined": [steps]}``.
    """
    directory = os.fspath(directory)
    steps = valid_steps(directory)
    target = latest_healthy_step(directory)
    doomed = [s for s in steps if target is None or s > target]
    moved: list[int] = []
    for s in doomed:
        _quarantine_move(directory, str(s))
        moved.append(s)
    if moved:
        tele = get_telemetry()
        tele.registry.counter("fault/rollbacks").inc()
        tele.event(
            "fault/rollback",
            directory=directory,
            to_step=target,
            quarantined=moved,
        )
    return {"to_step": target, "quarantined": moved}
