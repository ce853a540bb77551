"""The port's host control plane (``tpuframe_torch.core.native.ControlPlane``,
``csrc/controlplane.cpp``) against the JAX package's.

The cases of ``tests/test_native.py``'s ``TestControlPlane``, on the port's
own library: a world of one is a no-op; a rendezvous, barrier, broadcast
and allgather on 2 and 3 processes; a spoke with no hub times out; an
oversized payload is refused before it is sent; a spoke with the wrong
token cannot join.  Then the interop case, exact: a JAX hub
(``tpuframe.core.native.ControlPlane``, rank 0, in this process) and a port
spoke (rank 1, a spawned process that imports no JAX) run a barrier, a
broadcast and an allgather and agree byte for byte.  Last,
``track.broadcast_run_id`` over the plane on two gloo ranks: a 100-byte id
comes back whole (the process group's route cuts it at 64).
"""

import json
import multiprocessing as mp
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from torch_ranks import run_ranks
from tpuframe_torch.core.native import ControlPlane

REPO = Path(__file__).resolve().parents[1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cp_worker(rank, world, port, token, q):
    """Rendezvous, then the op sequence; reports the results or the error."""
    try:
        cp = ControlPlane(rank=rank, world=world, address="127.0.0.1", port=port,
                          timeout_ms=20_000, token=token)
        cp.barrier()
        run_id = cp.broadcast_str("run-abc123" if rank == 0 else None)
        gathered = cp.allgather_bytes(f"host{rank}".encode() * (rank + 1))
        cp.barrier()
        cp.close()
        q.put(("ok", rank, run_id, [g.decode() for g in gathered]))
    except BaseException as e:  # reported to the parent
        q.put(("err", rank, repr(e), None))


def _token_worker(rank, world, port, token, q):
    try:
        ControlPlane(rank=rank, world=world, address="127.0.0.1", port=port,
                     timeout_ms=3_000, token=token)
        q.put(("ok", rank, None, None))
    except BaseException as e:
        q.put(("err", rank, repr(e), None))


def _spawn(target, args_list):
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=target, args=(*a, q)) for a in args_list]
    for p in procs:
        p.start()
    try:
        return [q.get(timeout=60) for _ in procs]
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()


def test_world_of_one_is_a_noop():
    cp = ControlPlane(rank=0, world=1)
    cp.barrier()
    assert cp.broadcast_str("abc") == "abc"
    assert cp.allgather_bytes(b"x") == [b"x"]
    assert cp._h is None and cp.MAX_PAYLOAD == 1 << 20


@pytest.mark.parametrize("world", [2, 3])
def test_rendezvous_barrier_broadcast_allgather(world):
    port = _free_port()
    results = _spawn(_cp_worker, [(r, world, port, "tok") for r in range(world)])
    assert all(r[0] == "ok" for r in results), results
    want = [f"host{r}" * (r + 1) for r in range(world)]
    for _, _, run_id, gathered in results:
        assert run_id == "run-abc123" and gathered == want


def test_spoke_times_out_without_hub():
    with pytest.raises(TimeoutError, match="rendezvous failed"):
        ControlPlane(rank=1, world=2, address="127.0.0.1", port=_free_port(), timeout_ms=700)


def test_oversized_payload_refused_before_send():
    cp = ControlPlane(rank=0, world=1)
    cp.world = 2  # a multi-rank plane for the size check alone
    with pytest.raises(ValueError, match="exceeds MAX_PAYLOAD"):
        cp.broadcast_bytes(b"x" * (cp.MAX_PAYLOAD + 1))
    with pytest.raises(ValueError, match="exceeds MAX_PAYLOAD"):
        cp.allgather_bytes(b"x" * (cp.MAX_PAYLOAD + 1))


def test_wrong_token_cannot_join():
    # the hub expects "secret"; the spoke presents "wrong" and is turned
    # away: the hub fails by its timeout, not with a poisoned world
    port = _free_port()
    results = _spawn(_token_worker, [(0, 2, port, "secret"), (1, 2, port, "wrong")])
    hub = next(r for r in results if r[1] == 0)
    assert hub[0] == "err" and "TimeoutError" in hub[2], results


_PORT_SPOKE = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, sys.argv[1])
    from tpuframe_torch.core.native import ControlPlane
    cp = ControlPlane(rank=1, world=2, address="127.0.0.1", port=int(sys.argv[2]),
                      timeout_ms=30_000, token="interop")
    cp.barrier()
    got = cp.broadcast_bytes(None)
    parts = cp.allgather_bytes(bytes(range(256)) * 3 + b"spoke")
    cp.barrier()
    cp.close()
    assert not [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "tpuframe."))
                or m == "tpuframe"], "the spoke imported JAX"
    print(json.dumps({"broadcast": got.hex(), "parts": [p.hex() for p in parts]}))
""")


def test_a_port_spoke_joins_a_jax_hub_byte_for_byte():
    from tpuframe.core.native import ControlPlane as JaxControlPlane

    port = _free_port()
    spoke = subprocess.Popen([sys.executable, "-c", _PORT_SPOKE, str(REPO), str(port)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        payload = bytes(range(255, -1, -1)) * 7 + b"\x00hub"
        with JaxControlPlane(rank=0, world=2, address="127.0.0.1", port=port,
                             timeout_ms=30_000, token="interop") as hub:
            hub.barrier()
            sent = hub.broadcast_bytes(payload)
            parts = hub.allgather_bytes(b"hub\x00" * 9)
            hub.barrier()
        out, err = spoke.communicate(timeout=60)
    finally:
        if spoke.poll() is None:
            spoke.kill()
    assert spoke.returncode == 0, err.decode()[-2000:]
    got = json.loads(out.decode().strip().splitlines()[-1])
    assert sent == payload and bytes.fromhex(got["broadcast"]) == payload
    want = [b"hub\x00" * 9, bytes(range(256)) * 3 + b"spoke"]
    assert parts == want and [bytes.fromhex(p) for p in got["parts"]] == want


def _run_id_rank(rank, world, cp_port, run_id):
    from tpuframe_torch.core import initialize, native
    from tpuframe_torch.track import broadcast_run_id

    os.environ.update(MASTER_ADDR="127.0.0.1", TPUFRAME_CP_PORT=str(cp_port),
                      TPUFRAME_CP_TOKEN="run-id")
    initialize(device="cpu")
    got = broadcast_run_id(run_id if rank == 0 else None)
    return got, native._CONTROL_PLANE is not None


def test_broadcast_run_id_over_the_plane_keeps_a_long_id_whole(tmp_path):
    run_id = ("0123456789abcdef" * 7)[:100]  # past the group's 64 bytes
    results = run_ranks(_run_id_rank, 2, tmp_path, _free_port(), run_id, timeout=120)
    assert results == [(run_id, True), (run_id, True)]
