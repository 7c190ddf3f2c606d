"""A node agent's workers end when the agent dies, also where the orphans
are re-parented to a subreaper rather than to init, as they are under a
supervisor that collects what a program leaves behind.

Port only: each worker remembers the pid of the process that started it
(the agent on the cold spawn path, the zygote on the fork path) and exits
once its parent changes. A test for pid 1 would keep it alive forever
under a subreaper. Its watch on its parent runs from before it registers
with its agent.
"""
import os
import subprocess
import sys
import textwrap

import pytest

_HELPER = textwrap.dedent(
    """
    import ctypes, os, signal, time

    # orphans of this process's descendants come here, not to init
    assert ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0) == 0

    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.cluster.rpc import RpcClient

    def below(root):
        parent_of = {}
        for e in os.listdir("/proc"):
            if e.isdigit():
                try:
                    with open(f"/proc/{e}/stat") as f:
                        state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
                except OSError:
                    continue
                if state not in ("Z", "X"):
                    parent_of[int(e)] = int(ppid)
        out = set()
        for pid in parent_of:
            q = parent_of[pid]
            while q not in (root, 0) and q in parent_of:
                q = parent_of[q]
            if q == root:
                out.add(pid)
        return out

    def reap():
        try:
            while os.waitpid(-1, os.WNOHANG)[0]:
                pass
        except ChildProcessError:
            pass

    c = Cluster()
    try:
        node = c.add_node({"CPU": 2.0}, num_workers=2)
        agent = c._agents[node].pid
        rpc = RpcClient(c.agent_address(node))
        deadline = time.monotonic() + 60
        # both workers have registered and wait in their serve loop
        while len(rpc.call("DebugState", timeout=10.0)["idle_workers"]) < 2:
            assert time.monotonic() < deadline, "the agent's workers never registered"
            time.sleep(0.1)
        rpc.close()
        orphans = below(agent)
        c.kill_node(node)
        deadline = time.monotonic() + 15
        while below(os.getpid()) & orphans and time.monotonic() < deadline:
            reap()
            time.sleep(0.2)
        left = below(os.getpid()) & orphans
        for pid in left:
            os.kill(pid, signal.SIGKILL)
        print("ORPHANS", len(orphans), "LEFT", len(left), flush=True)
    finally:
        c.shutdown()
    """
)


@pytest.mark.parametrize("fork_server", ["1", "0"], ids=["zygote", "cold_spawn"])
def test_workers_end_with_their_agent_under_a_subreaper(fork_server):
    env = {
        **os.environ,
        "RAY_TPU_SCHED_PLATFORM": "cpu",
        "RAY_TPU_FORK_SERVER": fork_server,
    }
    proc = subprocess.run(
        [sys.executable, "-c", _HELPER],
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("ORPHANS")]
    assert line, proc.stdout[-2000:] + proc.stderr[-2000:]
    _, n, _, left = line[-1].split()
    assert int(n) >= 2 and int(left) == 0, line[-1]


_STARTING = textwrap.dedent(
    """
    import ctypes, os, socket, subprocess, sys, time

    assert ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0) == 0
    agent = socket.create_server(("127.0.0.1", 0))
    port = agent.getsockname()[1]
    # the middle process starts a worker, then waits to be killed
    middle = subprocess.Popen(
        [sys.executable, "-c",
         "import subprocess, sys, time; p = subprocess.Popen([sys.executable, '-m', "
         "'ray_tpu_torch.cluster.worker', '--agent', '127.0.0.1:%d', '--worker-id', 'w']); "
         "print(p.pid, flush=True); time.sleep(600)" % port],
        stdout=subprocess.PIPE, text=True,
    )
    worker = int(middle.stdout.readline())
    agent.settimeout(60)
    conn, _ = agent.accept()  # the worker is in its registration now
    conn.close()
    agent.close()  # no agent answers from here on
    middle.kill()
    middle.wait()
    t0 = time.monotonic()
    while time.monotonic() - t0 < 60 and not os.waitpid(worker, os.WNOHANG)[0]:
        time.sleep(0.05)
    print("ENDED_AFTER", round(time.monotonic() - t0, 2), flush=True)
    """
)


def test_a_starting_worker_ends_with_its_parent():
    """A worker whose parent dies while it registers with its agent ends
    at once, not after its registration's retries (~20 s) give up: a
    replacement worker forked as its agent shut down kept a serve
    cluster's shutdown waiting ~30 s on the card."""
    env = {**os.environ, "RAY_TPU_SCHED_PLATFORM": "cpu"}
    proc = subprocess.run(
        [sys.executable, "-c", _STARTING],
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("ENDED_AFTER")]
    assert line, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert float(line[-1].split()[1]) < 5.0, line[-1]
