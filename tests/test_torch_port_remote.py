"""The remote launcher (``tpuframe_torch.launch.RemoteDistributor``, the
agent ``python -m tpuframe_torch.launch.agent``) against
``tpuframe.launch.remote``, with two "hosts" on localhost.

The tier-1 cases of ``tests/test_remote.py``, on CPU agents
(``simulate_devices=1``): the env contract, held exactly against
``tpuframe.launch.RemoteDistributor._worker_env`` but for difference 30
(``LOCAL_RANK`` by a host's repeats, ``LOCAL_WORLD_SIZE``); the control
plane across two agents; stdout passing through with the result frame
intact; a typed failure with its host-tagged tail; a crashed peer surfacing
before the run-wide timeout, and the timeout itself; a failure frame behind
a wedged transport; ``ssh_connect``'s command shape (JAX's, but for the
module name); ``Distributor(local_mode=False)`` delegating, and refusing
without hosts; ``ScalingConfig(hosts=...)``; the orphaned agent's exit 17;
``simulate_devices=2`` refused.  ``slow``, as in JAX: a SIGKILLed worker
behind a transport that lingers is found by its silent beacon.

Then the knobs: every ``TPUFRAME_*`` name the port reads is in
``all_env_vars()`` or ``LAUNCH_CONTRACT_ENV_VARS``, ``all_env_vars()`` is a
subset of JAX's, and every knob of JAX's list that the port's lacks is
read nowhere in the port.

Each agent pays a torch import (~3 s); the runs take two agents each.
This module imports no JAX at its top: the agents import it.
"""

import ast
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest

from tpuframe_torch.launch import (
    Distributor,
    RemoteDistributor,
    RemoteLaunchError,
    ScalingConfig,
    TPUTrainer,
    WorkerLostError,
    all_env_vars,
    ssh_connect,
)
from tpuframe_torch.launch.agent import ORPHANED_EXIT
from tpuframe_torch.launch.remote import LAUNCH_CONTRACT_ENV_VARS

REPO = Path(__file__).resolve().parents[1]

#: a transport that lives on for a minute after its agent has exited, as an
#: ssh client can: the agent runs as its child, stdio inherited
_LINGER = ("import subprocess, sys, time\n"
           "rc = subprocess.call(sys.argv[1:])\n"
           "time.sleep(60)\n"
           "sys.exit(rc)\n")


def _two_hosts(hosts=("hostA", "hostB"), connect=lambda host: [], **kw):
    kw.setdefault("timeout_s", 120.0)
    kw.setdefault("simulate_devices", 1)
    return RemoteDistributor(list(hosts), connect=connect, remote_python=sys.executable,
                             master_addr="127.0.0.1", **kw)


def _contract():
    """The env each agent sees, its runtime, and an allgather over the
    control plane across the two agents."""
    from tpuframe_torch.core import initialize
    from tpuframe_torch.core.native import control_plane

    rt = initialize()
    import torch.distributed as dist

    cp = control_plane()
    cp.barrier()
    gathered = [b.decode() for b in cp.allgather_bytes(f"rank{cp.rank}".encode())]
    keys = ("RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "WORLD_SIZE", "MASTER_ADDR",
            "TPUFRAME_COORDINATOR", "TPUFRAME_SIMULATE_DEVICES", "TPUFRAME_HB_PORT")
    mine = {"env": {k: os.environ.get(k) for k in keys}, "device": str(rt.device),
            "backend": dist.get_backend()}
    everyone = [json.loads(b) for b in cp.allgather_bytes(json.dumps(mine).encode())]
    return {"ranks": everyone, "gathered": gathered}


def test_env_contract_and_control_plane_across_two_agents():
    rd = _two_hosts(hosts=("localhost", "localhost"))
    out = rd.run(_contract)
    assert out["gathered"] == ["rank0", "rank1"]
    for rank, r in enumerate(out["ranks"]):
        env = r["env"]
        assert env["RANK"] == str(rank) and env["WORLD_SIZE"] == "2"
        assert env["LOCAL_RANK"] == str(rank) and env["LOCAL_WORLD_SIZE"] == "2"
        assert env["MASTER_ADDR"] == "127.0.0.1" and env["TPUFRAME_SIMULATE_DEVICES"] == "1"
        assert env["TPUFRAME_COORDINATOR"].startswith("127.0.0.1:") and env["TPUFRAME_HB_PORT"]
        assert r["device"] == "cpu" and r["backend"] == "gloo"
    assert rd.heartbeat_active is True


@pytest.mark.parametrize("hosts", [("hostA", "hostB"), ("localhost", "localhost"),
                                   ("h0", "h1", "h0", "h2", "h1")])
def test_worker_env_is_jax_but_for_difference_30(hosts, monkeypatch):
    from tpuframe.launch.remote import RemoteDistributor as JaxRemoteDistributor

    for k in [k for k in os.environ if k.startswith("TPUFRAME_")]:
        monkeypatch.delenv(k)
    # knobs both launchers ship, and one that neither does
    monkeypatch.setenv("TPUFRAME_TELEMETRY_DIR", "/tmp/tele")
    monkeypatch.setenv("TPUFRAME_HEALTH_WINDOW", "7")
    monkeypatch.setenv("TPUFRAME_COMMS_COMPRESSION", "int8")
    monkeypatch.setenv("TPUFRAME_NOT_A_KNOB", "1")
    kw = dict(connect=lambda host: [], env={"EXTRA": "x", "TPUFRAME_HEALTH_WINDOW": "9"},
              simulate_devices=1, driver_addr="10.0.0.9")
    port, jax = RemoteDistributor(list(hosts), **kw), JaxRemoteDistributor(list(hosts), **kw)
    for rank, host in enumerate(hosts):
        args = (rank, "10.0.0.1", 29500, 29401, "tok", 29402)
        mine, theirs = port._worker_env(*args), jax._worker_env(*args)
        local = (hosts[:rank].count(host), hosts.count(host))
        assert (mine.pop("LOCAL_RANK"), mine.pop("LOCAL_WORLD_SIZE")) == tuple(map(str, local))
        assert theirs.pop("LOCAL_RANK") == "0"
        assert mine == theirs
    assert mine["TPUFRAME_HEALTH_WINDOW"] == "9" and mine["TPUFRAME_TELEMETRY_DIR"] == "/tmp/tele"
    assert "TPUFRAME_NOT_A_KNOB" not in mine


def _print_then_return():
    print("progress line 1")
    print("TPUFRAME_RESULT is just text mid-line, not a frame")
    return {"answer": 42}


def test_stdout_passes_through_with_the_frame_intact(capfd):
    assert _two_hosts().run(_print_then_return) == {"answer": 42}
    assert "progress line 1" in capfd.readouterr().out  # rank 0's stdout streamed


def _fail_on_rank1():
    if os.environ["RANK"] == "1":
        print("about to explode on hostB", file=sys.stderr)
        raise ValueError("rank1 typed failure")
    return "ok"


def test_typed_failure_with_host_tagged_tail():
    with pytest.raises(ValueError, match="rank1 typed failure") as info:
        _two_hosts().run(_fail_on_rank1)
    cause = info.value.__cause__
    assert isinstance(cause, RemoteLaunchError)
    assert cause.host == "hostB" and cause.rank == 1
    assert "about to explode on hostB" in cause.stderr_tail
    assert "found in sys.modules" not in cause.stderr_tail  # the agent runs clean as -m


def _crash_or_hang():
    if os.environ["RANK"] == "0":
        raise RuntimeError("root cause on hostA")
    time.sleep(60)


def test_a_crashed_peer_surfaces_before_the_run_wide_timeout():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="root cause on hostA"):
        _two_hosts(timeout_s=45.0).run(_crash_or_hang)
    assert time.monotonic() - t0 < 40  # the grace, not the deadline


def _hang():
    time.sleep(60)


def test_run_wide_timeout():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="still running"):
        _two_hosts(timeout_s=3.0).run(_hang)
    assert time.monotonic() - t0 < 30


def _rank1_raises():
    if os.environ["RANK"] == "1":
        raise ValueError("delivered failure frame")
    return "ok"


def test_a_failure_frame_behind_a_wedged_transport_surfaces():
    t0 = time.monotonic()
    with pytest.raises(ValueError, match="delivered failure frame"):
        _two_hosts(connect=lambda host: [sys.executable, "-c", _LINGER],
                   timeout_s=120.0).run(_rank1_raises)
    assert time.monotonic() - t0 < 45


def test_ssh_command_shape_is_jax_but_for_the_module():
    from tpuframe.launch.remote import RemoteDistributor as JaxRemoteDistributor

    rd, jax = RemoteDistributor(["tpu-host-0"]), JaxRemoteDistributor(["tpu-host-0"])
    cmd = rd._command("tpu-host-0")
    assert cmd[:4] == ["ssh", "-o", "BatchMode=yes", "tpu-host-0"] and rd.connect is ssh_connect
    # a shell transport: the agent's command is one quoted string
    assert cmd[4] == "python3 -u -m tpuframe_torch.launch.agent"
    assert cmd[:4] + [cmd[4].replace("tpuframe_torch.", "tpuframe.")] == jax._command(
        "tpu-host-0")
    argv = RemoteDistributor(["h"], connect=lambda h: ["env"])._command("h")
    assert argv == ["env", "python3", "-u", "-m", "tpuframe_torch.launch.agent"]
    assert rd.shell_quote and not RemoteDistributor(["h"], connect=lambda h: []).shell_quote


def _world():
    return {"world": os.environ["WORLD_SIZE"], "rank": os.environ["RANK"]}


def test_distributor_local_mode_false_delegates_and_needs_hosts():
    d = Distributor(local_mode=False, hosts=["hostA", "hostB"], connect=lambda host: [],
                    simulate_devices=1, timeout_s=120.0,
                    remote_kwargs={"remote_python": sys.executable, "master_addr": "127.0.0.1"})
    assert d.num_processes == 2 and isinstance(d._remote, RemoteDistributor)
    assert d.run(_world) == {"world": "2", "rank": "0"}
    with pytest.raises(ValueError, match="hosts"):
        Distributor(local_mode=False)


def _reporting_loop():
    from tpuframe_torch.launch import get_context, report

    ctx = get_context()
    report({"loss": 1.0 + ctx.get_world_rank(), "world": ctx.get_world_size()})


def test_tpu_trainer_places_one_rank_a_host(tmp_path):
    scaling = ScalingConfig(num_workers=2, simulate_devices=1, hosts=["hostA", "hostB"],
                            remote_kwargs={"connect": lambda host: [],
                                           "remote_python": sys.executable,
                                           "master_addr": "127.0.0.1", "timeout_s": 120.0})
    from tpuframe_torch.launch import RunConfig

    result = TPUTrainer(_reporting_loop, scaling_config=scaling,
                        run_config=RunConfig(storage_path=str(tmp_path))).fit()
    assert result.error is None and result.metrics == {"loss": 1.0, "world": 2}


def test_simulate_devices_above_1_is_refused():
    with pytest.raises(NotImplementedError, match="gloo processes"):
        RemoteDistributor(["hostA", "hostB"], simulate_devices=2)
    with pytest.raises(NotImplementedError, match="gloo processes"):
        Distributor(local_mode=False, hosts=["hostA", "hostB"], simulate_devices=2)


def _hang_started(started):
    Path(started).write_text("hanging")
    time.sleep(60)


def test_an_orphaned_agent_exits_17(tmp_path):
    """ssh does not signal a remote command when its local client dies;
    stdin EOF is the agent's death watch."""
    import cloudpickle

    started = tmp_path / "started"
    payload = cloudpickle.dumps((_hang_started, (str(started),), {}))
    header = json.dumps({"payload_bytes": len(payload), "env": {}}).encode() + b"\n"
    p = subprocess.Popen(
        [sys.executable, "-u", "-m", "tpuframe_torch.launch.agent"], stdin=subprocess.PIPE,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        env={**os.environ, "PYTHONPATH": os.pathsep.join(
            [str(REPO), os.path.dirname(__file__), os.environ.get("PYTHONPATH", "")])})
    try:
        p.stdin.write(header + payload)
        p.stdin.flush()
        deadline = time.monotonic() + 60
        while not started.exists() and p.poll() is None and time.monotonic() < deadline:
            time.sleep(0.1)  # the fn hangs: the watchdog is armed
        assert started.exists(), p.poll()
        p.stdin.close()  # the driver is gone
        assert p.wait(timeout=20) == ORPHANED_EXIT
    finally:
        if p.poll() is None:
            p.kill()


def _rank1_dies_rank0_hangs():
    import signal

    if os.environ["RANK"] == "1":
        time.sleep(2.0)  # the beacon is heard first
        os.kill(os.getpid(), signal.SIGKILL)
    time.sleep(120)


@pytest.mark.slow
def test_heartbeat_detects_worker_behind_lingering_transport():
    """What polling the process cannot see: the transport outlives the
    worker (ssh does for a kill on the host).  The silent beacon is a
    ``WorkerLostError`` within seconds, not at the run's deadline."""
    rd = _two_hosts(connect=lambda host: [sys.executable, "-c", _LINGER],
                    heartbeat_timeout_s=3.0, timeout_s=300.0)
    t0 = time.monotonic()
    with pytest.raises(WorkerLostError) as info:
        rd.run(_rank1_dies_rank0_hangs)
    elapsed = time.monotonic() - t0
    assert info.value.rank == 1 and elapsed < 60, f"detection took {elapsed:.1f}s"


# -- the knobs --------------------------------------------------------------------

_KNOB = re.compile(r"^TPUFRAME_[A-Z0-9_]*[A-Z0-9]$")


def _port_knobs() -> dict[str, list[str]]:
    """Every full ``TPUFRAME_*`` name written as a string in the port's code
    (docstrings and the config overlay's ``SECTION__KEY`` form apart) ->
    where."""
    out: dict[str, list[str]] = {}
    for path in sorted((REPO / "tpuframe_torch").rglob("*.py")):
        tree = ast.parse(path.read_text())
        docs = {id(n.body[0].value) for n in ast.walk(tree)
                if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                  ast.AsyncFunctionDef))
                and n.body and isinstance(n.body[0], ast.Expr)
                and isinstance(n.body[0].value, ast.Constant)}
        for n in ast.walk(tree):
            if (isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docs
                    and _KNOB.match(n.value) and "__" not in n.value):
                out.setdefault(n.value, []).append(f"{path.relative_to(REPO)}:{n.lineno}")
    return out


def test_every_knob_the_port_reads_is_shipped_or_part_of_the_contract():
    knobs = _port_knobs()
    assert len(knobs) > 40 and "TPUFRAME_CKPT_SAVE_RETRIES" in knobs
    loose = {k: v for k, v in knobs.items()
             if k not in all_env_vars() and k not in LAUNCH_CONTRACT_ENV_VARS}
    assert not loose, loose
    assert len(set(all_env_vars())) == len(all_env_vars())


def test_all_env_vars_is_jaxs_less_the_knobs_the_port_never_reads():
    from tpuframe.launch.remote import LAUNCH_CONTRACT_ENV_VARS as JAX_CONTRACT
    from tpuframe.launch.remote import all_env_vars as jax_all_env_vars

    ours, theirs = set(all_env_vars()), set(jax_all_env_vars())
    assert ours <= theirs, sorted(ours - theirs)
    knobs = _port_knobs()
    read = {k: knobs[k] for k in theirs - ours if k in knobs}
    assert not read, read
    assert LAUNCH_CONTRACT_ENV_VARS == JAX_CONTRACT
