"""Job submission (reference: python/ray/job_submission/ — JobSubmissionClient,
JobStatus, JobInfo; backed by the dashboard job manager,
python/ray/dashboard/modules/job/job_manager.py), on the port's runtime.

Jobs are driver SUBPROCESSES attached to the running session via
`ray_tpu_torch.init(address="auto")` (the session's unix socket, inherited
through RTPT_ADDRESS). A `_JobManager` actor — named, detached, zero-CPU,
loading no torch — spawns each entrypoint in its own process group,
streams combined stdout/stderr to a per-job log file, and reports status
from the process state. The job's process claims no card: the manager is a
worker without a GPU claim, so the job inherits `CUDA_VISIBLE_DEVICES=""`,
and a job's card work runs in the `num_gpus` actors its driver starts.
Killing a job kills its process group; the controller's worker-death
reconciliation then releases anything the dead driver still pinned (actor
handles, streams), so a stopped job's unnamed actors die and return their
cards.

The `JobSubmissionClient` talks either to that actor directly (in-session or
via socket attach) or to a dashboard HTTP endpoint (`http://...`) with the
reference's `/api/jobs` routes.
"""

import json
import os
import signal
import subprocess
import time
import uuid
from dataclasses import asdict, dataclass, field
from enum import Enum
from typing import Dict, Iterator, List, Optional

JOB_MANAGER_NAME = "_rtpt_job_manager"
JOB_MANAGER_NAMESPACE = "_system"


class JobStatus(str, Enum):
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    STOPPED = "STOPPED"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"

    def is_terminal(self) -> bool:
        return self in (JobStatus.STOPPED, JobStatus.SUCCEEDED, JobStatus.FAILED)


@dataclass
class JobInfo:
    submission_id: str
    entrypoint: str
    status: str = JobStatus.PENDING.value
    message: str = ""
    start_time: float = 0.0
    end_time: Optional[float] = None
    exit_code: Optional[int] = None
    metadata: Dict[str, str] = field(default_factory=dict)
    log_path: str = ""

    def to_dict(self):
        return asdict(self)


class _JobManager:
    """Actor body. One instance per session (named detached actor)."""

    def __init__(self):
        self._jobs: Dict[str, JobInfo] = {}
        self._procs: Dict[str, subprocess.Popen] = {}
        from ray_tpu_torch._private import paths
        self._dir = paths.subdir(f"jobs-{os.getpid()}")

    def submit(self, entrypoint: str, submission_id: Optional[str] = None,
               env_vars: Optional[Dict[str, str]] = None,
               working_dir: Optional[str] = None,
               metadata: Optional[Dict[str, str]] = None) -> str:
        jid = submission_id or f"rtpt-job-{uuid.uuid4().hex[:10]}"
        if jid in self._jobs:
            raise ValueError(f"submission_id {jid!r} already used")
        log_path = os.path.join(self._dir, f"{jid}.log")
        env = {**os.environ, **(env_vars or {})}
        # the job is a driver against THIS session, not a fresh one
        env.setdefault("RTPT_JOB_SUBMISSION_ID", jid)
        logf = open(log_path, "ab")
        try:
            proc = subprocess.Popen(
                entrypoint, shell=True, stdout=logf, stderr=subprocess.STDOUT,
                stdin=subprocess.DEVNULL, cwd=working_dir or None, env=env,
                start_new_session=True)  # own pgroup: stop() kills the tree
        finally:
            logf.close()  # the child holds the fd now
        self._procs[jid] = proc
        self._jobs[jid] = JobInfo(
            submission_id=jid, entrypoint=entrypoint,
            status=JobStatus.RUNNING.value, start_time=time.time(),
            metadata=metadata or {}, log_path=log_path)
        return jid

    def _refresh(self, jid: str):
        info = self._jobs.get(jid)
        proc = self._procs.get(jid)
        if info is None or proc is None:
            return
        if info.status == JobStatus.RUNNING.value:
            rc = proc.poll()
            if rc is not None:
                info.exit_code = rc
                info.end_time = time.time()
                info.status = (JobStatus.SUCCEEDED.value if rc == 0
                               else JobStatus.FAILED.value)
                info.message = f"exit code {rc}"

    def get_info(self, jid: str) -> dict:
        self._refresh(jid)
        info = self._jobs.get(jid)
        if info is None:
            raise ValueError(f"no such job {jid!r}")
        return info.to_dict()

    def list(self) -> List[dict]:
        for jid in self._jobs:
            self._refresh(jid)
        return [i.to_dict() for i in self._jobs.values()]

    def stop(self, jid: str, grace_s: float = 3.0) -> bool:
        self._refresh(jid)
        info = self._jobs.get(jid)
        proc = self._procs.get(jid)
        if info is None or proc is None:
            raise ValueError(f"no such job {jid!r}")
        if JobStatus(info.status).is_terminal():
            return False
        try:
            os.killpg(proc.pid, signal.SIGTERM)
        except ProcessLookupError:
            pass
        deadline = time.time() + grace_s
        while time.time() < deadline and proc.poll() is None:
            time.sleep(0.05)
        if proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait(timeout=5)
        info.exit_code = proc.returncode
        info.end_time = time.time()
        info.status = JobStatus.STOPPED.value
        info.message = "stopped via stop_job"
        return True

    def logs(self, jid: str, offset: int = 0, max_bytes: int = 1 << 20):
        """Returns (chunk_bytes, next_offset, terminal)."""
        info = self.get_info(jid)
        try:
            with open(info["log_path"], "rb") as f:
                f.seek(offset)
                chunk = f.read(max_bytes)
        except FileNotFoundError:
            chunk = b""
        return chunk, offset + len(chunk), JobStatus(info["status"]).is_terminal()


def _get_or_create_manager():
    import ray_tpu_torch as rt
    try:
        return rt.get_actor(JOB_MANAGER_NAME,
                                 namespace=JOB_MANAGER_NAMESPACE)
    except ValueError:
        try:
            mgr_cls = rt.remote(num_cpus=0)(_JobManager)
            return mgr_cls.options(name=JOB_MANAGER_NAME,
                                   namespace=JOB_MANAGER_NAMESPACE,
                                   lifetime="detached").remote()
        except ValueError:
            # lost the creation race with another driver
            return rt.get_actor(JOB_MANAGER_NAME,
                                     namespace=JOB_MANAGER_NAMESPACE)


class JobSubmissionClient:
    """Reference surface: submit_job / get_job_status / get_job_info /
    list_jobs / get_job_logs / tail_job_logs / stop_job.

    address: None (use the current session, initializing from RTPT_ADDRESS
    if needed), a controller socket path, or an http:// dashboard endpoint.
    """

    def __init__(self, address: Optional[str] = None):
        self._http = None
        if address and address.startswith("http"):
            self._http = address.rstrip("/")
            return
        import ray_tpu_torch as rt
        if not rt.is_initialized():
            rt.init(address=address or "auto")
        self._mgr = _get_or_create_manager()

    # ------------------------------------------------------------- actor path
    def _call(self, method, *args, **kw):
        import ray_tpu_torch as rt
        return rt.get(getattr(self._mgr, method).remote(*args, **kw),
                           timeout=60)

    # -------------------------------------------------------------- http path
    def _request(self, method, path, payload=None):
        import urllib.request
        data = None if payload is None else json.dumps(payload).encode()
        req = urllib.request.Request(
            self._http + path, data=data, method=method,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            return json.loads(r.read() or b"null")

    # ---------------------------------------------------------------- surface
    def submit_job(self, *, entrypoint: str, submission_id: Optional[str] = None,
                   runtime_env: Optional[dict] = None,
                   metadata: Optional[Dict[str, str]] = None) -> str:
        rte = runtime_env or {}
        if self._http:
            return self._request("POST", "/api/jobs/", {
                "entrypoint": entrypoint, "submission_id": submission_id,
                "runtime_env": rte, "metadata": metadata,
            })["submission_id"]
        return self._call("submit", entrypoint, submission_id,
                          rte.get("env_vars"), rte.get("working_dir"), metadata)

    def get_job_info(self, submission_id: str) -> JobInfo:
        if self._http:
            d = self._request("GET", f"/api/jobs/{submission_id}")
        else:
            d = self._call("get_info", submission_id)
        return JobInfo(**d)

    def get_job_status(self, submission_id: str) -> JobStatus:
        return JobStatus(self.get_job_info(submission_id).status)

    def list_jobs(self) -> List[JobInfo]:
        rows = (self._request("GET", "/api/jobs/") if self._http
                else self._call("list"))
        return [JobInfo(**d) for d in rows]

    def get_job_logs(self, submission_id: str) -> str:
        """Full log snapshot, paginated so large logs aren't truncated."""
        out, offset = [], 0
        while True:
            if self._http:
                d = self._request(
                    "GET", f"/api/jobs/{submission_id}/logs?offset={offset}")
                chunk, offset = d["logs"].encode(), d["next_offset"]
            else:
                chunk, offset, _ = self._call("logs", submission_id, offset)
            if not chunk:
                return b"".join(out).decode("utf-8", "replace")
            out.append(chunk)

    def tail_job_logs(self, submission_id: str,
                      poll_s: float = 0.3) -> Iterator[str]:
        """Yields log chunks until the job reaches a terminal state."""
        offset = 0
        while True:
            if self._http:
                d = self._request(
                    "GET", f"/api/jobs/{submission_id}/logs?offset={offset}")
                chunk = d["logs"].encode()
                offset, terminal = d["next_offset"], d["terminal"]
            else:
                chunk, offset, terminal = self._call(
                    "logs", submission_id, offset)
            if chunk:
                yield chunk.decode("utf-8", "replace")
            if terminal and not chunk:
                return
            if not chunk:
                time.sleep(poll_s)

    def stop_job(self, submission_id: str) -> bool:
        if self._http:
            return self._request(
                "POST", f"/api/jobs/{submission_id}/stop")["stopped"]
        return self._call("stop", submission_id)

    def wait_until_finished(self, submission_id: str,
                            timeout_s: float = 300) -> JobStatus:
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            st = self.get_job_status(submission_id)
            if st.is_terminal():
                return st
            time.sleep(0.2)
        raise TimeoutError(f"job {submission_id} still running after {timeout_s}s")
