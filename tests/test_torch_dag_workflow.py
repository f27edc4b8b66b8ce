"""Compiled actor DAGs and durable workflows on the port's runtime
(`ray_tpu_torch.dag`, `ray_tpu_torch.workflow`) against `ray_tpu`'s.

The nine programs of `tests/test_dag_workflow.py` are written once against
a package and run for each in a fresh interpreter of its own, both at once
(as `tests/test_torch_runtime.py` does); each gives one reading a JAX case,
equal to JAX's where it does not depend on timing, and the pipelining
case's wall time holds JAX's bound on each. `.bind` on a remote function
and on an actor method builds a `FunctionNode` / `ClassMethodNode` (they
raised NotImplementedError before the port had dag), compiled DAGs refuse
task nodes and empty graphs with JAX's errors, and the port's journal lives
under its own per-user root, apart from JAX's.

No jax at this module's top: the scenarios import it in their own
interpreters, the port's never."""

import importlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent
PACKAGES = ("ray_tpu", "ray_tpu_torch")
STAGE_S = 0.4


def _dag_programs(ray, dag):
    out = {}

    @ray.remote
    class Stage:
        def __init__(self, tag):
            self.tag = tag

        def work(self, x):
            return x + [self.tag]

    a, b, c = Stage.remote("a"), Stage.remote("b"), Stage.remote("c")
    with dag.InputNode() as inp:
        out_node = c.work.bind(b.work.bind(a.work.bind(inp)))
    compiled = out_node.experimental_compile()
    first = ray.get(compiled.execute([0]), timeout=60)
    outs = ray.get([compiled.execute([i]) for i in range(5)], timeout=60)
    out["compiled_dag_pipeline"] = [first, outs]
    out["node_types"] = [type(out_node).__name__, type(a.work.bind(1)).__name__]

    @ray.remote
    class Slow:
        def work(self, x):
            time.sleep(STAGE_S)
            return x + 1

    s1, s2 = Slow.remote(), Slow.remote()
    with dag.InputNode() as inp:
        piped = s2.work.bind(s1.work.bind(inp)).experimental_compile()
    ray.get(piped.execute(0), timeout=60)
    t0 = time.time()
    outs = ray.get([piped.execute(i) for i in range(3)], timeout=60)
    out["compiled_dag_pipelining_overlaps"] = outs
    out["pipelined_s"] = time.time() - t0

    @ray.remote
    class Math:
        def add(self, x, y):
            return x + y

        def mul(self, x, y):
            return x * y

    m = Math.remote()
    with dag.InputNode() as inp:
        multi = dag.MultiOutputNode([m.add.bind(inp[0], inp[1]), m.mul.bind(inp[0], inp[1])])
    out["compiled_dag_multi_output_and_input_access"] = ray.get(
        multi.experimental_compile().execute((3, 4)), timeout=60)

    @ray.remote
    def task(x):
        return x

    errors = []
    for node in (task.bind(1), dag.InputNode()):
        try:
            node.experimental_compile()
        except (TypeError, ValueError) as e:
            errors.append([type(e).__name__, str(e).split(";")[0].split(" ray_tpu")[0]])
    out["compile_refusals"] = errors
    return out


def _workflow_programs(ray, workflow, root):
    out = {}
    calls_file = os.path.join(root, "calls.txt")

    def count(path, word=None):
        if not os.path.exists(path):
            return 0
        text = open(path).read()
        return text.count("\n") if word is None else text.count(word)

    @ray.remote
    def load(x):
        with open(calls_file, "a") as f:
            f.write(f"load:{x}\n")
        return list(range(x))

    @ray.remote
    def square(xs):
        with open(calls_file, "a") as f:
            f.write("square\n")
        return [v * v for v in xs]

    @ray.remote
    def total(xs):
        with open(calls_file, "a") as f:
            f.write("total\n")
        return sum(xs)

    wid = f"wf_test_{time.time_ns()}"
    first = workflow.run(total.bind(square.bind(load.bind(5))), workflow_id=wid)
    status = workflow.get_status(wid)
    before = count(calls_file)
    again = workflow.run(total.bind(square.bind(load.bind(5))), workflow_id=wid)
    out["workflow_run_and_resume"] = dict(
        first=first, status=status, again=again, new_calls=count(calls_file) - before,
        resumed=workflow.resume(wid),
        listed=any(w["workflow_id"] == wid for w in workflow.list_all()))
    out["journal_dir"] = os.path.dirname(workflow._wf_dir(wid))
    workflow.delete(wid)
    out["workflow_run_and_resume"]["deleted"] = not os.path.exists(workflow._wf_dir(wid))

    marker = os.path.join(root, "fail_once")
    open(marker, "w").write("fail")
    loads = os.path.join(root, "loads.txt")

    @ray.remote
    def produce():
        with open(loads, "a") as f:
            f.write("produce\n")
        return 21

    @ray.remote
    def flaky(x):
        if os.path.exists(marker):
            raise RuntimeError("transient failure")
        return x * 2

    wid = f"wf_fail_{time.time_ns()}"
    try:
        workflow.run(flaky.bind(produce.bind()), workflow_id=wid)
        raised = None
    except Exception as e:  # noqa: BLE001 - the reading is that it raised
        raised = "transient failure" in str(e)
    failed = workflow.get_status(wid)
    os.unlink(marker)
    out["workflow_failure_then_resume_skips_done_steps"] = dict(
        raised=raised, failed=failed, resumed=workflow.resume(wid, flaky.bind(produce.bind())),
        produce_calls=count(loads, "produce"), status=workflow.get_status(wid))
    workflow.delete(wid)

    @ray.remote
    def fac(n, acc=1):
        if n <= 1:
            return acc
        return workflow.continuation(fac.bind(n - 1, acc * n))

    wid = f"wf_cont_{time.time_ns()}"
    out["workflow_continuation_recursion"] = [
        workflow.run(fac.bind(12), workflow_id=wid), workflow.get_status(wid),
        workflow.resume(wid)]
    workflow.delete(wid)

    @ray.remote
    def countdown(n, acc=0):
        if n == 0:
            return acc
        return workflow.continuation(countdown.bind(n - 1, acc + 1))

    wid = f"wf_deep_{time.time_ns()}"
    out["workflow_continuation_deep_chain"] = [
        workflow.run(countdown.bind(1200), workflow_id=wid), workflow.resume(wid)]
    workflow.delete(wid)

    marker2 = os.path.join(root, "fail_cont")
    open(marker2, "w").write("x")
    calls = os.path.join(root, "cont_calls.txt")

    @ray.remote
    def finisher(x):
        with open(calls, "a") as f:
            f.write("finisher\n")
        if os.path.exists(marker2):
            raise RuntimeError("transient")
        return x + 1

    @ray.remote
    def starter():
        with open(calls, "a") as f:
            f.write("starter\n")
        return workflow.continuation(finisher.bind(41))

    wid = f"wf_cont_fail_{time.time_ns()}"
    try:
        workflow.run(starter.bind(), workflow_id=wid)
        raised = None
    except Exception:  # noqa: BLE001
        raised = True
    failed = workflow.get_status(wid)
    os.unlink(marker2)
    out["workflow_continuation_resume_skips_parent"] = dict(
        raised=raised, failed=failed, resumed=workflow.resume(wid, starter.bind()),
        starter=count(calls, "starter"), finisher=count(calls, "finisher"))
    workflow.delete(wid)

    @ray.remote
    def expand(n):
        return workflow.continuation(tally.bind(list(range(n))))

    @ray.remote
    def tally(xs):
        return sum(xs)

    @ray.remote
    def double(x):
        return 2 * x

    wid = f"wf_cont_mid_{time.time_ns()}"
    out["workflow_continuation_mid_dag"] = workflow.run(double.bind(expand.bind(5)),
                                                        workflow_id=wid)
    workflow.delete(wid)
    return out


def _scenario(pkg, root):
    ray = importlib.import_module(pkg)
    dag = importlib.import_module(f"{pkg}.dag")
    workflow = importlib.import_module(f"{pkg}.workflow")
    paths = importlib.import_module(f"{pkg}._private.paths")
    ray.init(num_cpus=4)
    try:
        out = _dag_programs(ray, dag)
        out.update(_workflow_programs(ray, workflow, root))
        out["journal_under_own_root"] = out.pop("journal_dir") == os.path.join(
            paths.user_tmp_root(), "workflows")
        out["root_name"] = os.path.basename(paths.user_tmp_root())
    finally:
        ray.shutdown()
    return out


@pytest.fixture(scope="module")
def readings(tmp_path_factory):
    procs = {}
    for pkg in PACKAGES:
        env = dict(os.environ, JAX_PLATFORMS="cpu", RAY_TPU_NUM_CHIPS="0")
        for var in ("RAY_TPU_ARENA", "RAY_TPU_ADDRESS", "RTPT_ARENA", "RTPT_ADDRESS"):
            env.pop(var, None)
        env["PYTHONPATH"] = os.pathsep.join([str(REPO), str(TESTS), env.get("PYTHONPATH", "")])
        root = str(tmp_path_factory.mktemp(pkg))
        code = (f"import json, test_torch_dag_workflow as m; "
                f"print(json.dumps(m._scenario({pkg!r}, {root!r})))")
        procs[pkg] = subprocess.Popen([sys.executable, "-c", code], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                      cwd=str(REPO))
    got = {}
    for pkg, p in procs.items():
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-4000:]
        got[pkg] = json.loads(out.strip().splitlines()[-1])
    return got


@pytest.mark.parametrize("key", [
    "compiled_dag_pipeline", "compiled_dag_pipelining_overlaps",
    "compiled_dag_multi_output_and_input_access", "workflow_run_and_resume",
    "workflow_failure_then_resume_skips_done_steps", "workflow_continuation_recursion",
    "workflow_continuation_deep_chain", "workflow_continuation_resume_skips_parent",
    "workflow_continuation_mid_dag", "node_types", "compile_refusals",
    "journal_under_own_root"])
def test_program_matches_ray_tpu(readings, key):
    assert readings["ray_tpu_torch"][key] == readings["ray_tpu"][key]


def test_readings_hold_jax_assertions(readings):
    got = readings["ray_tpu_torch"]
    first, outs = got["compiled_dag_pipeline"]
    assert first == [0, "a", "b", "c"] and outs[4] == [4, "a", "b", "c"]
    assert got["node_types"] == ["ClassMethodNode", "ClassMethodNode"]
    assert got["compiled_dag_pipelining_overlaps"] == [2, 3, 4]
    assert got["compiled_dag_multi_output_and_input_access"] == [7, 12]
    assert got["workflow_run_and_resume"] == dict(first=30, status="SUCCESSFUL", again=30,
                                                  new_calls=0, resumed=30, listed=True,
                                                  deleted=True)
    assert got["workflow_failure_then_resume_skips_done_steps"] == dict(
        raised=True, failed="FAILED", resumed=42, produce_calls=1, status="SUCCESSFUL")
    assert got["workflow_continuation_recursion"] == [479001600, "SUCCESSFUL", 479001600]
    assert got["workflow_continuation_deep_chain"] == [1200, 1200]
    assert got["workflow_continuation_resume_skips_parent"] == dict(
        raised=True, failed="FAILED", resumed=42, starter=1, finisher=2)
    assert got["workflow_continuation_mid_dag"] == 20
    assert got["journal_under_own_root"] and got["root_name"].startswith("ray_tpu_torch")
    assert not readings["ray_tpu"]["root_name"].startswith("ray_tpu_torch")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_compiled_dag_pipelining_beats_serial(readings, pkg):
    """3 items through 2 stages of 0.4 s: under 95% of the 2.4 s a serial
    run takes (test_dag_workflow.py's bound), on each runtime."""
    assert readings[pkg]["pipelined_s"] < 6 * STAGE_S * 0.95


def test_bind_builds_nodes_without_a_session():
    """`RemoteFunction.bind` builds a FunctionNode with its arguments and
    the function's name, as JAX's does; no session is needed to build."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.dag import FunctionNode

    def step(x, y=0):
        return x + y

    node = rt.remote(step).bind(1, y=2)
    inner = rt.remote(step).bind(node)
    assert isinstance(node, FunctionNode) and node.args == (1,) and node.kwargs == {"y": 2}
    assert node.name == "step" and inner.args == (node,)
