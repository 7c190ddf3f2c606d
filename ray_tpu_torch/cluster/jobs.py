"""Job submission: run driver entrypoints against the cluster.

The analog of the reference's job-submission stack
(Ray's python/ray/dashboard/modules/job/: REST API +
JobSubmissionClient at sdk.py:36, with a JobSupervisor running the
entrypoint). Here the head's JobManager launches each entrypoint as a
subprocess with ``RAY_TPU_HEAD_ADDRESS`` set, so any ``ray_tpu_torch`` API call
in the script auto-connects as a driver; stdout/stderr are captured per
job and served back over RPC (and the dashboard).

Port of ``ray_tpu/cluster/jobs.py``, copied with its imports rewritten.
"""
from __future__ import annotations

import os
import shlex
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .common import new_id
from .rpc import RpcClient

# terminal + live states (reference JobStatus enum,
# dashboard/modules/job/common.py)
PENDING = "PENDING"
RUNNING = "RUNNING"
SUCCEEDED = "SUCCEEDED"
FAILED = "FAILED"
STOPPED = "STOPPED"


@dataclass
class JobInfo:
    job_id: str
    entrypoint: str
    status: str = PENDING
    start_time: float = 0.0
    end_time: float = 0.0
    return_code: Optional[int] = None
    log_path: str = ""
    runtime_env: Optional[dict] = None
    metadata: Dict[str, str] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "job_id": self.job_id,
            "entrypoint": self.entrypoint,
            "status": self.status,
            "start_time": self.start_time,
            "end_time": self.end_time,
            "return_code": self.return_code,
            "metadata": dict(self.metadata),
        }


class JobManager:
    """Head-side job lifecycle (JobSupervisor analog, but a plain
    subprocess on the head host rather than an actor)."""

    def __init__(
        self,
        head_address: Optional[str],
        log_dir: Optional[str] = None,
        on_change=None,
    ):
        self.head_address = head_address
        self.log_dir = log_dir or os.path.join(
            tempfile.gettempdir(), "ray_tpu_torch_job_logs"
        )
        os.makedirs(self.log_dir, exist_ok=True)
        self._jobs: Dict[str, JobInfo] = {}
        self._procs: Dict[str, subprocess.Popen] = {}
        self._lock = threading.Lock()
        self._on_change = on_change or (lambda: None)

    def snapshot(self) -> List[dict]:
        """Durable job table rows (head persistence)."""
        with self._lock:
            return [
                {**i.to_dict(), "log_path": i.log_path}
                for i in self._jobs.values()
            ]

    def restore(self, row: dict) -> None:
        """Re-load a persisted job row after a head restart. Jobs that were
        live have lost their subprocess — mark them failed."""
        info = JobInfo(
            job_id=row["job_id"],
            entrypoint=row["entrypoint"],
            status=row["status"],
            start_time=row.get("start_time", 0.0),
            end_time=row.get("end_time", 0.0),
            return_code=row.get("return_code"),
            log_path=row.get("log_path", ""),
            metadata=dict(row.get("metadata", {})),
        )
        if info.status in (PENDING, RUNNING):
            info.status = FAILED
            info.end_time = time.time()
        with self._lock:
            self._jobs[info.job_id] = info

    def submit(
        self,
        entrypoint: str,
        runtime_env: Optional[dict] = None,
        submission_id: Optional[str] = None,
        metadata: Optional[Dict[str, str]] = None,
    ) -> str:
        if self.head_address is None:
            # head is mid-bootstrap (RPC server bound, address not yet
            # published to us) — a clean retryable error beats spawning a
            # job with RAY_TPU_HEAD_ADDRESS unset.
            raise RuntimeError("head is not ready to accept jobs yet")
        job_id = submission_id or f"raytpu-job-{new_id()}"
        with self._lock:
            if job_id in self._jobs:
                raise ValueError(f"job {job_id} already exists")
            info = JobInfo(
                job_id=job_id,
                entrypoint=entrypoint,
                runtime_env=runtime_env,
                metadata=dict(metadata or {}),
                log_path=os.path.join(self.log_dir, f"{job_id}.log"),
            )
            self._jobs[job_id] = info
        self._on_change()
        threading.Thread(
            target=self._run, args=(info,), name=f"job-{job_id}", daemon=True
        ).start()
        return job_id

    def _run(self, info: JobInfo) -> None:
        env = dict(os.environ)
        env["RAY_TPU_HEAD_ADDRESS"] = self.head_address
        env["RAY_TPU_JOB_ID"] = info.job_id
        # entrypoints run from arbitrary cwds: make the framework importable
        import ray_tpu_torch

        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(ray_tpu_torch.__file__)))
        existing = env.get("PYTHONPATH", "")
        if pkg_root not in existing.split(os.pathsep):
            env["PYTHONPATH"] = (
                pkg_root + (os.pathsep + existing if existing else "")
            )
        renv = info.runtime_env or {}
        for k, v in (renv.get("env_vars") or {}).items():
            env[k] = str(v)
        cwd = renv.get("working_dir") or None
        info.start_time = time.time()
        try:
            with open(info.log_path, "wb") as log:
                proc = subprocess.Popen(
                    shlex.split(info.entrypoint),
                    env=env,
                    cwd=cwd,
                    stdout=log,
                    stderr=subprocess.STDOUT,
                )
                with self._lock:
                    # submit() raced a stop(): honor it
                    if info.status == STOPPED:
                        proc.kill()
                        proc.wait()  # reap; no zombie for the head lifetime
                        return
                    info.status = RUNNING
                    self._procs[info.job_id] = proc
            rc = proc.wait()
            with self._lock:
                info.return_code = rc
                info.end_time = time.time()
                if info.status != STOPPED:
                    info.status = SUCCEEDED if rc == 0 else FAILED
            self._on_change()
        except Exception as exc:  # noqa: BLE001 - entrypoint must not kill head
            with self._lock:
                info.status = FAILED
                info.end_time = time.time()
            try:
                with open(info.log_path, "ab") as log:
                    log.write(f"\njob manager error: {exc!r}\n".encode())
            except OSError:
                pass
        finally:
            with self._lock:
                self._procs.pop(info.job_id, None)

    def stop(self, job_id: str) -> bool:
        with self._lock:
            info = self._jobs.get(job_id)
            proc = self._procs.get(job_id)
            if info is None:
                return False
            if info.status in (SUCCEEDED, FAILED, STOPPED):
                return False
            info.status = STOPPED
            info.end_time = time.time()
        self._on_change()
        if proc is not None:
            try:
                proc.terminate()
                try:
                    proc.wait(timeout=3)
                except subprocess.TimeoutExpired:
                    proc.kill()
            except OSError:
                pass
        return True

    def status(self, job_id: str) -> dict:
        with self._lock:
            info = self._jobs.get(job_id)
            if info is None:
                raise ValueError(f"unknown job {job_id}")
            return info.to_dict()

    def logs(self, job_id: str) -> str:
        with self._lock:
            info = self._jobs.get(job_id)
        if info is None:
            raise ValueError(f"unknown job {job_id}")
        try:
            with open(info.log_path, "rb") as f:
                return f.read().decode(errors="replace")
        except OSError:
            return ""

    def list(self) -> List[dict]:
        with self._lock:
            return [i.to_dict() for i in self._jobs.values()]

    def shutdown(self) -> None:
        with self._lock:
            procs = list(self._procs.values())
        for p in procs:
            try:
                p.kill()
            except OSError:
                pass


class JobSubmissionClient:
    """Driver-side client (reference sdk.py:36 parity surface)."""

    def __init__(self, address: str):
        self._client = RpcClient(address)
        self._client.call("Ping", timeout=10.0, retries=10, retry_interval=0.2)

    def submit_job(
        self,
        *,
        entrypoint: str,
        runtime_env: Optional[dict] = None,
        submission_id: Optional[str] = None,
        metadata: Optional[Dict[str, str]] = None,
    ) -> str:
        return self._client.call(
            "SubmitJob",
            {
                "entrypoint": entrypoint,
                "runtime_env": runtime_env,
                "submission_id": submission_id,
                "metadata": metadata,
            },
        )

    def get_job_status(self, job_id: str) -> str:
        return self._client.call("JobStatus", {"job_id": job_id})["status"]

    def get_job_info(self, job_id: str) -> dict:
        return self._client.call("JobStatus", {"job_id": job_id})

    def get_job_logs(self, job_id: str) -> str:
        return self._client.call("JobLogs", {"job_id": job_id})

    def list_jobs(self) -> List[dict]:
        return self._client.call("ListJobs")

    def stop_job(self, job_id: str) -> bool:
        return self._client.call("StopJob", {"job_id": job_id})

    def wait_until_finished(
        self, job_id: str, timeout: float = 300.0, poll: float = 0.25
    ) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            status = self.get_job_status(job_id)
            if status in (SUCCEEDED, FAILED, STOPPED):
                return status
            time.sleep(poll)
        raise TimeoutError(f"job {job_id} still running after {timeout}s")
