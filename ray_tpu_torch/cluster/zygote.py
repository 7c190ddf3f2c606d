"""Fork-server ("zygote") for millisecond worker spawn.

The agent's cold spawn path pays a full interpreter start + the worker
module graph import (grpc, cloudpickle, torch) per worker: seconds on a loaded host, and the dominant cost of
actor churn. The reference avoids it
with worker_pool.cc's prestarted idle workers; CPython can do one
better: ONE process (this module) pays the import exactly once, then
``os.fork()`` clones it per worker in milliseconds.

Design constraints that keep fork safe:

- The zygote is single-threaded: a line-oriented stdin/stdout protocol,
  no RPC server, no grpc channels, no event loops. grpc and torch are
  only *imported* here — neither creates core threads or backends until
  first object/backend use, which happens post-fork in the child. The
  zygote never touches CUDA (no ``torch.cuda.is_available()``, no device
  bring-up): a child forked after the CUDA driver is initialised cannot
  use the card.
- Children reset SIGCHLD, detach from the protocol pipes (stdout is
  re-pointed at stderr so a printing worker can never corrupt a reply),
  then run the exact same ``worker.run_worker`` entry as a cold spawn.
- ``ray_tpu_torch._ids`` registers an ``os.register_at_fork`` hook, so forked
  workers never mint ids from an inherited entropy buffer.

The agent's first zygote is forked from the agent process itself
(``prefork``), before the agent starts a thread: the agent has already
imported the package and torch, so that zygote is ready in milliseconds
instead of paying a second interpreter start and import (seconds on a
loaded host, which every new node's first worker waited out). Its first
protocol line gives it the agent's address, the store path and its
environment; a replacement zygote (after one broke) is spawned as a new
process, since the agent has threads by then.

Lifecycle chaining: the zygote exits on stdin EOF (its agent died), and
forked workers exit when their parent pid is no longer the zygote's
(their zygote died) — the same orphan check the cold path relies on, one
level deeper.

Protocol (one JSON object per line):

    agent -> zygote   {"cmd": "fork", "worker_id": ..., "env": {...}}
                      {"cmd": "reap"}
    zygote -> agent   {"pid": 12345, "exited": [...]} | {"error": "..."}
                      {"exited": [...]}

Every reply carries the pids the zygote reaped since the last reply:
pids recycle once reaped, so ``os.kill(pid, 0)`` alone could see a dead
worker as alive forever (and a later SIGKILL could hit an innocent
process). ``ForkedProc.poll`` consults the client's reaped-set first;
the agent's report loop calls ``drain_exits()`` each sweep to keep it
fresh.

The agent-side ``ZygoteClient`` lives here too so the whole fork-server
surface is one file.

Port of ``ray_tpu/cluster/zygote.py``, copied with its imports rewritten.
The reference's jax platform pin before the fork is gone.
"""
from __future__ import annotations

import json
import os
import select
import subprocess
import sys
import threading
import time
from typing import Dict, Optional

_READY_LINE = b'{"ready": true}\n'


# ---------------------------------------------------------------------------
# agent side
# ---------------------------------------------------------------------------
class ForkedProc:
    """Popen-shaped handle for a worker forked by the zygote (the child
    belongs to the zygote, so ``waitpid`` is unavailable here). Liveness:
    the owning client's reaped-exit set is authoritative (immune to pid
    reuse); signal 0 covers the window before the next protocol reply."""

    def __init__(self, pid: int, owner: Optional["ZygoteClient"] = None):
        self.pid = pid
        self.returncode: Optional[int] = None
        self._owner = owner

    def poll(self) -> Optional[int]:
        if self.returncode is not None:
            return self.returncode
        if self._owner is not None and self.pid in self._owner.exited:
            self.returncode = -9
            return self.returncode
        try:
            os.kill(self.pid, 0)
            return None
        except OSError:
            self.returncode = -9
            return self.returncode

    def _signal(self, sig: int) -> None:
        if self.returncode is not None:
            return
        os.kill(self.pid, sig)

    def kill(self) -> None:
        import signal

        self._signal(signal.SIGKILL)

    def terminate(self) -> None:
        import signal

        self._signal(signal.SIGTERM)


def fork_available() -> bool:
    return hasattr(os, "fork") and sys.platform != "win32"


class PreforkedZygote:
    """Popen-shaped handle for a zygote forked from the agent process
    (``prefork``): its pid, the write end of its stdin and the read end of
    its stdout. The zygote is the agent's own child, so ``waitpid`` reaps
    it."""

    def __init__(self, pid: int, stdin, stdout):
        self.pid = pid
        self.stdin = stdin
        self.stdout = stdout
        self.returncode: Optional[int] = None

    def poll(self) -> Optional[int]:
        if self.returncode is None:
            try:
                pid, status = os.waitpid(self.pid, os.WNOHANG)
            except ChildProcessError:
                self.returncode = -9
                return self.returncode
            if pid:
                self.returncode = os.waitstatus_to_exitcode(status)
        return self.returncode

    def _signal(self, sig: int) -> None:
        if self.poll() is None:
            try:
                os.kill(self.pid, sig)
            except OSError:
                pass

    def kill(self) -> None:
        import signal

        self._signal(signal.SIGKILL)

    def terminate(self) -> None:
        import signal

        self._signal(signal.SIGTERM)


def prefork() -> Optional[PreforkedZygote]:
    """Fork this process into a zygote that waits for its configuration
    (the agent's address, the store path, its environment) as the
    first line on its stdin, then serves the fork protocol. Call it only
    while this process has one thread: the child keeps only the calling
    thread. None where fork is unavailable or fails."""
    if not fork_available() or threading.active_count() > 1:
        return None
    req_r, req_w = os.pipe()
    rep_r, rep_w = os.pipe()
    try:
        pid = os.fork()
    except OSError:
        for fd in (req_r, req_w, rep_r, rep_w):
            os.close(fd)
        return None
    if pid == 0:  # the zygote
        code = 1
        try:
            os.close(req_w)
            os.close(rep_r)
            os.dup2(req_r, 0)
            os.dup2(rep_w, 1)
            os.close(req_r)
            os.close(rep_w)
            conf = json.loads(sys.stdin.readline() or "null")
            if conf is not None:
                os.environ.update(conf.get("env") or {})
                _serve(conf["agent"], conf.get("store", ""))
            code = 0
        finally:
            os._exit(code)  # never the agent's exit handlers
    os.close(req_r)
    os.close(rep_w)
    return PreforkedZygote(pid, os.fdopen(req_w, "wb", buffering=0), os.fdopen(rep_r, "rb", buffering=0))


class ZygoteClient:
    """Agent-side handle to one zygote process.

    ``fork_worker`` is the only hot call: serialized under one lock
    (forks are ms-scale), returns a ``ForkedProc`` or ``None`` on ANY
    failure — the caller falls back to cold spawn. A client that broke
    stays broken (the agent may start a replacement). Given ``preforked``
    (``prefork``'s handle), the client configures that zygote instead of
    spawning one."""

    def __init__(
        self,
        agent_address: str,
        store_path: str,
        env: Dict[str, str],
        preforked: Optional[PreforkedZygote] = None,
    ):
        self._lock = threading.Lock()
        self._buf = b""
        self.broken = False
        self._ready = False
        # pids the zygote reaped — the pid-reuse-proof death signal
        # ForkedProc.poll consults (set ops are GIL-atomic)
        self.exited: set = set()
        if preforked is not None:
            self.proc = preforked
            conf = {"agent": agent_address, "store": store_path, "env": dict(env)}
            self.proc.stdin.write(json.dumps(conf).encode() + b"\n")
            self.proc.stdin.flush()
            return
        self.proc = subprocess.Popen(
            [
                sys.executable,
                "-m",
                "ray_tpu_torch.cluster.zygote",
                "--agent",
                agent_address,
                "--store",
                store_path,
            ],
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            bufsize=0,
            env=env,
        )

    def _read_line(self, deadline: float) -> Optional[bytes]:
        """One protocol line from the zygote, or None on timeout/EOF."""
        fd = self.proc.stdout.fileno()
        while b"\n" not in self._buf:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            r, _, _ = select.select([fd], [], [], min(remaining, 0.25))
            if not r:
                if self.proc.poll() is not None:
                    return None
                continue
            chunk = os.read(fd, 4096)
            if not chunk:  # EOF: zygote died
                return None
            self._buf += chunk
        line, self._buf = self._buf.split(b"\n", 1)
        return line

    def _wait_ready(self, deadline: float) -> bool:
        if self._ready:
            return True
        line = self._read_line(deadline)
        if line is None or json.loads(line).get("ready") is not True:
            return False
        self._ready = True
        return True

    def fork_worker(
        self,
        worker_id: str,
        env: Optional[Dict[str, str]] = None,
        timeout: Optional[float] = None,
    ) -> Optional[ForkedProc]:
        if timeout is None:
            from ray_tpu_torch.config import cfg

            timeout = cfg.zygote_ready_timeout_s
        with self._lock:
            if self.broken:
                return None
            deadline = time.monotonic() + timeout
            try:
                if not self._wait_ready(deadline):
                    self.broken = True
                    return None
                req = {"cmd": "fork", "worker_id": worker_id, "env": env or {}}
                self.proc.stdin.write(json.dumps(req).encode() + b"\n")
                self.proc.stdin.flush()
                line = self._read_line(deadline)
                if line is None:
                    self.broken = True
                    return None
                reply = json.loads(line)
                self.exited.update(reply.get("exited") or ())
                pid = reply.get("pid")
                if pid is None:
                    self.broken = True
                    return None
                return ForkedProc(int(pid), owner=self)
            except (OSError, ValueError):
                self.broken = True
                return None

    def drain_exits(self) -> set:
        """Pull reaped-child pids from the zygote (pid-reuse-proof death
        detection for forked workers). NEVER blocks on the client lock:
        the agent's report loop calls this ahead of its NodeReport, and a
        fork_worker holding the lock through the zygote's import warmup
        must not stall heartbeats into a false node death. No-op while
        the zygote is warming; any protocol failure marks it broken."""
        if not self._lock.acquire(blocking=False):
            return self.exited  # a fork is in flight; catch up next tick
        try:
            if self.broken or self.proc.poll() is not None:
                return self.exited
            if not self._ready and not self._wait_ready(
                time.monotonic() + 0.01
            ):
                return self.exited  # still importing; nothing forked yet
            try:
                self.proc.stdin.write(b'{"cmd": "reap"}\n')
                self.proc.stdin.flush()
                line = self._read_line(time.monotonic() + 5.0)
                if line is None:
                    self.broken = True
                    return self.exited
                self.exited.update(json.loads(line).get("exited") or ())
            except (OSError, ValueError):
                self.broken = True
            return self.exited
        finally:
            self._lock.release()

    def close(self) -> None:
        with self._lock:
            self.broken = True
            try:
                self.proc.stdin.close()
            except OSError:
                pass
            try:
                self.proc.terminate()
            except OSError:
                pass


# ---------------------------------------------------------------------------
# zygote process side
# ---------------------------------------------------------------------------
_EXITED: list = []  # reaped child pids, drained into protocol replies


def _reap(_sig=None, _frm=None) -> None:
    """Collect exited forked workers and record their pids: reaping frees
    the pid for reuse, so the AGENT must learn the death through the
    protocol, not through signal-0 probes."""
    try:
        while True:
            pid, _ = os.waitpid(-1, os.WNOHANG)
            if pid == 0:
                break
            _EXITED.append(pid)  # list.append is signal/GIL safe
    except ChildProcessError:
        pass


def _child_main(agent_address: str, store_path: str, req: dict, zygote_pid: int) -> None:
    """Runs in the forked child: detach from the zygote's protocol pipes,
    apply per-worker env, become a normal worker process."""
    import signal

    signal.signal(signal.SIGCHLD, signal.SIG_DFL)
    devnull = os.open(os.devnull, os.O_RDWR)
    os.dup2(devnull, 0)
    os.dup2(2, 1)  # user prints must never corrupt the reply pipe
    os.close(devnull)
    for k, v in (req.get("env") or {}).items():
        os.environ[k] = str(v)
    from . import worker as worker_mod

    worker_mod.run_worker(agent_address, req["worker_id"], store_path, parent=zygote_pid)


def main() -> None:
    import argparse

    parser = argparse.ArgumentParser(description="ray_tpu_torch worker fork-server")
    parser.add_argument("--agent", required=True)
    parser.add_argument("--store", default="")
    args = parser.parse_args()
    _serve(args.agent, args.store)


def _serve(agent_address: str, store_path: str) -> None:
    """The zygote's life: warm the imports, say ready, serve forks until
    stdin closes."""
    import signal

    # Pay the worker's import graph ONCE, pre-fork: the package (and so
    # torch) is imported, but CUDA is not initialised, so no driver state
    # or threads exist at fork time. RAY_TPU_ZYGOTE_PRELOAD names extra
    # modules to warm.
    from . import worker as _worker_mod  # noqa: F401 - import for side effect
    for name in filter(None, os.environ.get("RAY_TPU_ZYGOTE_PRELOAD", "").split(",")):
        try:
            __import__(name.strip())
        except Exception:  # noqa: BLE001 - best-effort warmup
            pass

    signal.signal(signal.SIGCHLD, _reap)
    out = sys.stdout.buffer
    out.write(_READY_LINE)
    out.flush()

    def reply(obj: dict) -> None:
        n = len(_EXITED)
        obj["exited"], _EXITED[:n] = _EXITED[:n], []
        try:
            out.write(json.dumps(obj).encode() + b"\n")
            out.flush()
        except OSError:  # agent closed the pipe mid-reply (shutdown race)
            sys.exit(0)

    while True:
        line = sys.stdin.readline()
        if not line:  # EOF: the agent died; forked workers follow via ppid
            return
        try:
            req = json.loads(line)
        except ValueError:
            continue
        cmd = req.get("cmd")
        if cmd == "exit":
            return
        if cmd == "reap":
            reply({})
            continue
        if cmd != "fork":
            reply({"error": "unknown cmd"})
            continue
        zygote_pid = os.getpid()
        try:
            pid = os.fork()
        except OSError as exc:
            reply({"error": repr(exc)})
            continue
        if pid == 0:
            try:
                _child_main(agent_address, store_path, req, zygote_pid)
            finally:
                os._exit(1)
        reply({"pid": pid})


if __name__ == "__main__":
    main()
