"""ray_tpu_torch.train.TorchTrainer against ray_tpu.train.JaxTrainer (in
process) on the CPU.

One loop body is written once against a `train` module (`ray_tpu.train`
or `ray_tpu_torch.train`), its state from a seeded numpy generator, and
run through each package's trainer for every scenario of
tests/test_train.py and test_train_orchestration.py's world check: the
`Result` fields, the `checkpoint_*` directories left, `progress.jsonl` and
each checkpoint's decoded state must be equal (the formats differ, orbax
or pickle against torch.save, so the states are compared by content).
Then the dataset split against JAX's on a `ray_tpu.data` dataset, the
slice as a whole on the tiny Llama (JAX's flax and optax loop under
JaxTrainer against the port's loop under TorchTrainer, failing once at
step 3: losses within LOSS_RTOL; the port's loop under both trainers:
torch.equal), and the port's `TrainWorker` as a `ray_tpu` actor killed
mid-run. The multi-rank cases are in test_torch_trainer_world.py."""

import json
import os
import subprocess
import sys
import weakref

import cloudpickle
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ray_tpu.data as rdata
from ray_tpu import train as jtrain
from ray_tpu.models import llama as jllama
from ray_tpu.ops.losses import chunked_cross_entropy as j_chunked_ce
from ray_tpu.train import worker_group as jwg
from ray_tpu_torch import train as ttrain
from ray_tpu_torch.train import Checkpoint, iter_device_batches
from ray_tpu_torch.train import worker_group as twg
from ray_tpu_torch.train.llm_step import build_llama_trainer, host_batches

PACKAGES = {"jax": (jtrain, jtrain.JaxTrainer), "torch": (ttrain, ttrain.TorchTrainer)}
LOSS_RTOL = 1e-5          # tests/test_torch_train.py: f32, summation order only
STEPS, FAIL_AT = 6, 3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T = 2, 32


# ---------------------------------------------------------------- scenarios
def linreg_loop(train, seen, config):
    """tests/test_train.py's linear regression in numpy f32: a checkpoint
    (w, step) each step, a failure at `fail_at` once, before its report."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 3)).astype(np.float32)
    y = x @ np.array([1.0, -2.0, 0.5], np.float32)
    w, start = np.zeros(3, np.float32), 0
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        state = ckpt.to_state()
        w, start = np.asarray(state["w"], np.float32), int(state["step"])
    for i in range(start, config["steps"]):
        err = x @ w - y
        loss = float(np.mean(err ** 2))
        w = w - np.float32(0.1 * 2 / 64) * (x.T @ err)
        if i == config.get("fail_at") and not seen.get("failed"):
            seen["failed"] = True
            raise RuntimeError("injected failure")
        train.report({"loss": loss, "step": i},
                     checkpoint=train.Checkpoint.from_state({"w": w, "step": i + 1}))


def always_fail(train, seen, config):
    raise ValueError("boom")


def scored_loop(train, seen, config):
    for i, score in enumerate([1.0, 5.0, 2.0, 4.0]):
        train.report({"score": score},
                     checkpoint=train.Checkpoint.from_state({"i": i, "s": score}))


def acc_loop(train, seen, config):
    for i in range(100):
        train.report({"acc": i / 10.0})


def context_loop(train, seen, config):
    ctx = train.get_context()
    train.report({"world": [ctx.get_world_size(), ctx.get_world_rank()],
                  "local": [ctx.get_local_rank(), ctx.get_local_world_size(),
                            ctx.get_node_rank()],
                  "names": [ctx.get_experiment_name(), ctx.get_trial_name(),
                            ctx.get_trial_id(), os.path.basename(ctx.get_trial_dir())],
                  "data": list(train.get_dataset_shard("train"))})
    with pytest.raises(KeyError, match="no dataset shard named 'eval'; have \\['train'\\]"):
        train.get_dataset_shard("eval")


def noop_loop(train, seen, config):
    pass


NONE = lambda t: {}
# name -> (loop, train_loop_config, RunConfig fields, trainer kwargs); the
# last two are built from the package's train module
SCENARIOS = {
    "fit_end_to_end": (linreg_loop, {"steps": 12}, NONE, NONE),
    "failure_recovery": (linreg_loop, {"steps": 10, "fail_at": 5},
                         lambda t: {"failure_config": t.FailureConfig(max_failures=1)}, NONE),
    "failures_exhausted": (always_fail, {},
                           lambda t: {"failure_config": t.FailureConfig(max_failures=1)}, NONE),
    "keep_n": (linreg_loop, {"steps": 8},
               lambda t: {"checkpoint_config": t.CheckpointConfig(num_to_keep=3)}, NONE),
    "keep_best_max": (scored_loop, {}, lambda t: {"checkpoint_config": t.CheckpointConfig(
        num_to_keep=2, checkpoint_score_attribute="score", checkpoint_score_order="max")}, NONE),
    "keep_best_min": (scored_loop, {}, lambda t: {"checkpoint_config": t.CheckpointConfig(
        num_to_keep=2, checkpoint_score_attribute="score", checkpoint_score_order="min")}, NONE),
    "stop_dict": (acc_loop, {}, lambda t: {"stop": {"acc": 0.5}}, NONE),
    "stop_callable": (acc_loop, {}, lambda t: {"stop": lambda m: m["acc"] >= 0.5}, NONE),
    "session_context_and_datasets": (context_loop, {}, NONE,
                                     lambda t: {"datasets": {"train": [1, 2, 3]}}),
    "num_workers_4_without_world": (noop_loop, {}, NONE, lambda t: {
        "scaling_config": t.ScalingConfig(num_workers=4)}),
    "num_workers_2_without_world": (noop_loop, {}, NONE, lambda t: {
        "scaling_config": t.ScalingConfig(num_workers=2)}),
}


def _decoded(pkg, path):
    """A checkpoint's state, as lists, read by its own package."""
    state = PACKAGES[pkg][0].Checkpoint(path).to_state()
    return {k: np.asarray(v).tolist() for k, v in state.items()}


def run_scenario(pkg, name, root):
    """Everything fit() and its directory show, with paths as basenames."""
    train, trainer_cls = PACKAGES[pkg]
    loop, config, run_fields, fit_kw = SCENARIOS[name]
    seen = {}
    trainer = trainer_cls(
        lambda cfg: loop(train, seen, cfg), train_loop_config=dict(config),
        run_config=train.RunConfig(name=name, storage_path=str(root / pkg), **run_fields(train)),
        # JAX's default looks for a ray_tpu runtime; the port's is in process
        **({"use_worker_actor": False} if pkg == "jax" else {}), **fit_kw(train))
    try:
        result = trainer.fit()
    except ValueError as e:
        return {"raised": (type(e).__name__, str(e).split(" but the ")[0])}
    exp = result.path
    progress = os.path.join(exp, "progress.jsonl")
    dirs = sorted(d for d in os.listdir(exp) if d.startswith("checkpoint_"))
    return {
        "path": os.path.relpath(exp, root / pkg),
        "metrics": result.metrics,
        "history": result.metrics_history,
        "error": result.error and (type(result.error).__name__, str(result.error)),
        "checkpoint": result.checkpoint and os.path.basename(result.checkpoint.path),
        "best": [(os.path.basename(c.path), s) for c, s in result.best_checkpoints],
        "dirs": dirs,
        "states": {d: _decoded(pkg, os.path.join(exp, d)) for d in dirs},
        "progress": ([json.loads(line) for line in open(progress)]
                     if os.path.exists(progress) else None),
    }


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_jax(name, tmp_path):
    want = run_scenario("jax", name, tmp_path)
    got = run_scenario("torch", name, tmp_path)
    assert got == want
    # the scenarios' own claims, as tests/test_train.py makes them
    if name == "fit_end_to_end":
        losses = [m["loss"] for m in got["history"]]
        assert len(losses) == 12 and losses[-1] < losses[0] / 10
        assert got["states"][got["checkpoint"]]["step"] == 12
    elif name == "failure_recovery":
        assert [m["step"] for m in got["history"]] == list(range(10))
        assert got["states"][got["checkpoint"]]["step"] == 10
    elif name == "failures_exhausted":
        assert got["error"] == ("ValueError", "boom") and got["history"] == []
    elif name == "keep_n":
        assert len(got["dirs"]) == 3 and got["states"][got["checkpoint"]]["step"] == 8
    elif name.startswith("keep_best"):
        kept = sorted(got["states"][d]["s"] for d, _ in got["best"])
        assert kept == ([4.0, 5.0] if name.endswith("max") else [1.0, 2.0])
    elif name.startswith("stop"):
        assert got["metrics"]["acc"] == 0.5 and len(got["history"]) == 6
    elif name == "session_context_and_datasets":
        assert got["metrics"]["world"] == [1, 0] and got["metrics"]["data"] == [1, 2, 3]
    else:
        assert got["raised"][0] == "ValueError" and "num_workers=" in got["raised"][1]


def test_report_outside_a_session_raises_as_jax():
    errors = []
    for train, _ in PACKAGES.values():
        for call in (lambda: train.report({"x": 1}), train.get_checkpoint, train.get_context):
            with pytest.raises(RuntimeError) as e:
                call()
            errors.append(str(e.value))
    assert len(set(errors)) == 1 and errors[0].startswith("No train session active")


def test_configs_match_jax():
    for cls in ("ScalingConfig", "CheckpointConfig", "FailureConfig", "RunConfig",
                "DataConfig", "SyncConfig", "BackendConfig"):
        j, t = getattr(jtrain, cls), getattr(ttrain, cls)
        jf = {f.name: f.default for f in j.__dataclass_fields__.values()}
        tf = {f.name: f.default for f in t.__dataclass_fields__.values()}
        assert tf == jf, cls
    for bad in (dict(checkpoint_score_order="mean"), dict(num_to_keep=0)):
        msgs = []
        for pkg in (jtrain, ttrain):
            with pytest.raises(ValueError) as e:
                pkg.CheckpointConfig(**bad)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    assert ttrain.TRAIN_DATASET_KEY == jtrain.TRAIN_DATASET_KEY == "train"
    assert issubclass(ttrain.TrainingFailedError, RuntimeError)
    # the one difference: cards are "GPU", read from use_gpu (JAX: "TPU" from use_tpu)
    assert ttrain.ScalingConfig(use_gpu=True, chips_per_worker=2).as_resources() == \
        {"CPU": 1, "GPU": 2}
    assert jtrain.ScalingConfig(use_tpu=True, chips_per_worker=2).as_resources() == \
        {"CPU": 1, "TPU": 2}
    assert ttrain.ScalingConfig(use_tpu=True).as_resources() == {"CPU": 1}
    names = ["a", "b", "c"]
    for cfg in ("all", ["b"], []):
        assert (ttrain.DataConfig(cfg).split_names(names)
                == jtrain.DataConfig(cfg).split_names(names))


def test_worker_actor_is_not_in_process(tmp_path):
    """use_worker_actor=True runs the loop in a TrainWorker actor of the
    port's runtime (another process), and reports back through its Result."""
    import ray_tpu_torch as rt

    def loop():
        import os
        from ray_tpu_torch import train
        train.report({"pid": os.getpid()})

    rt.init(num_cpus=1, num_gpus=0)
    try:
        result = ttrain.TorchTrainer(
            loop, use_worker_actor=True,
            run_config=ttrain.RunConfig(name="actor", storage_path=str(tmp_path))).fit()
    finally:
        rt.shutdown()
    assert result.error is None and len(result.metrics_history) == 1
    assert result.metrics["pid"] != os.getpid()


def test_retry_starts_without_the_failed_attempts_state(tmp_path):
    """The failed attempt's frames are cleared before the retry, so its
    model is freed when the retry starts: a card holds one copy of the
    training state, not two. The kept error has its type and message."""
    refs, alive = [], []

    def loop():
        if refs:
            alive.append(refs[0]() is not None)
            return
        model = torch.nn.Linear(4, 4)
        refs.append(weakref.ref(model))
        raise RuntimeError("first attempt fails")

    result = ttrain.TorchTrainer(loop, run_config=ttrain.RunConfig(
        name="retry", storage_path=str(tmp_path),
        failure_config=ttrain.FailureConfig(max_failures=1))).fit()
    assert result.error is None and alive == [False]
    refs.clear()
    result = ttrain.TorchTrainer(loop, run_config=ttrain.RunConfig(
        name="exhausted", storage_path=str(tmp_path))).fit()
    assert (type(result.error), str(result.error)) == (RuntimeError, "first attempt fails")


def test_port_imports_with_jax_and_ray_tpu_blocked():
    code = (
        "import importlib.abc, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'orbax',"
        " 'ray_tpu', 'cloudpickle', 'pandas'):\n"
        "            raise ImportError('blocked ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import ray_tpu_torch.train as t\n"
        "print(' '.join(sorted(t.__all__)))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert {"TorchTrainer", "Result", "ScalingConfig", "RunConfig", "CheckpointConfig",
            "FailureConfig", "DataConfig", "report", "get_checkpoint", "get_context",
            "get_dataset_shard", "TrainContext", "TrainingStopped"} <= names
    # every name of JAX's but its trainer's (the port's is TorchTrainer)
    assert set(jtrain.__all__) - names == {"JaxTrainer"}


# ---------------------------------------------------------------- datasets
def _rows(shards):
    return {name: (([r["id"] for r in ds.take_all()]) if hasattr(ds, "take_all") else ds)
            for name, ds in shards.items()}


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("to_split", ["all", ["train"]])
def test_dataset_shards_match_jax(world, to_split):
    datasets = {"train": rdata.range(20), "eval": rdata.range(7), "plain": [1, 2, 3],
                "text": "abc", "tensor": torch.arange(6)}
    jcfg, tcfg = jtrain.DataConfig(to_split), ttrain.DataConfig(to_split)
    jpre = jwg.presplit_datasets(datasets, jcfg, world)
    tpre = twg.presplit_datasets(datasets, tcfg, world)
    for rank in range(world):
        want = _rows(jwg._shard_datasets(datasets, jcfg, world, rank))
        got = _rows(twg._shard_datasets(datasets, tcfg, world, rank))
        assert got["tensor"] is datasets["tensor"]
        got["tensor"] = want["tensor"] = None
        assert got == want
        assert _rows(tpre[rank]) == _rows(jpre[rank]) == {**want, "tensor": datasets["tensor"]}
        assert len(want["train"]) == 20 // world
        assert (want["eval"] == list(range(7))) == (to_split != "all")
    assert _rows(twg._shard_datasets(datasets, tcfg, 1, 0))["train"] == list(range(20))


# ---------------------------------------------------------------- the slice
_JAX = {}


def _jax_llama():
    """tests/test_torch_train.py's JAX step: the tiny preset in f32,
    flax params from PRNGKey(0), optax.adamw(1e-4), chunked CE on the head."""
    if not _JAX:
        cfg = jllama.LlamaConfig.tiny(param_dtype=jnp.float32, dtype=jnp.float32,
                                      max_seq_len=T, remat=False, attn_impl="xla")
        model = jllama.Llama(cfg)
        batches = host_batches(cfg.vocab_size, B, T)
        params = model.init(jax.random.PRNGKey(0), jnp.asarray(batches[0])[:2, :-1])
        opt = optax.adamw(1e-4)

        def loss_fn(params, tokens):
            hidden, _ = model.apply(params, tokens[:, :-1], return_hidden=True)
            loss, _ = j_chunked_ce(hidden, params["params"]["lm_head"]["kernel"],
                                   tokens[:, 1:], chunk_size=T)
            return loss

        @jax.jit
        def step(params, opt_state, tokens):
            loss, grads = jax.value_and_grad(loss_fn)(params, tokens)
            updates, opt_state = opt.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state, loss

        _JAX.update(params=params, opt_state=opt.init(params), step=step, batches=batches)
    return _JAX


def jax_llama_loop(seen, config):
    """The JAX loop under JaxTrainer: its state's leaves checkpointed each
    step by orbax, restored into the tree by their order."""
    j = _jax_llama()
    params, opt_state = j["params"], j["opt_state"]
    treedef = jax.tree_util.tree_structure((params, opt_state))
    start = 0
    ckpt = jtrain.get_checkpoint()
    if ckpt is not None:
        state = ckpt.to_state()
        leaves = [jnp.asarray(state["leaves"][k]) for k in sorted(state["leaves"])]
        params, opt_state = jax.tree_util.tree_unflatten(treedef, leaves)
        start = int(state["step"])
        seen.setdefault("resumed_from", []).append(start)
    for i in range(start, STEPS):
        params, opt_state, loss = j["step"](params, opt_state, jnp.asarray(j["batches"][i]))
        if i == config["fail_at"] and not seen.get("failed"):
            seen["failed"] = True
            raise RuntimeError("injected failure")
        seen.setdefault("losses", {})[i] = float(loss)
        leaves = jax.device_get(jax.tree_util.tree_leaves((params, opt_state)))
        jtrain.report({"loss": float(loss), "step": i}, checkpoint=jtrain.Checkpoint.from_state(
            {"leaves": {f"{k:04d}": np.asarray(v) for k, v in enumerate(leaves)},
             "step": i + 1}))


def port_llama_loop(train, seen, config):
    """The port's loop, written once for either trainer's session: the port's
    tiny Llama from `params` (JAX's, carried across) fed by
    iter_device_batches, checkpointed with the port's Checkpoint."""
    model, opt, step, batches, _ = build_llama_trainer(
        "tiny", B, T, device="cpu", dtype=torch.float32, remat=False, params=config["params"])
    start = 0
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        state = Checkpoint.from_directory(ckpt.path).to_state(
            target={"model": model.state_dict(), "optim": opt.state_dict()})
        model.load_state_dict(state["model"])
        opt.load_state_dict(state["optim"])
        start = state["step"]
        seen.setdefault("resumed_from", []).append(start)
    for i, tokens in zip(range(start, STEPS), iter_device_batches(batches[start:STEPS],
                                                                  device="cpu")):
        loss = step(tokens)
        if i == config["fail_at"] and not seen.get("failed"):
            seen["failed"] = True
            raise RuntimeError("injected failure")
        seen.setdefault("losses", {})[i] = loss.clone()
        train.report({"loss": float(loss), "step": i}, checkpoint=Checkpoint.from_state(
            {"model": model.state_dict(), "optim": opt.state_dict(), "step": i + 1},
            path=os.path.join(config["scratch"], f"step{i + 1}")))
    seen["params"] = {k: v.clone() for k, v in model.state_dict().items()}


def _fit_llama(trainer_cls, loop, root, name, **config):
    scratch = root / f"{name}-scratch"
    scratch.mkdir()
    train = jtrain if trainer_cls is jtrain.JaxTrainer else ttrain
    result = trainer_cls(
        loop, train_loop_config=dict(config, fail_at=FAIL_AT, scratch=str(scratch)),
        run_config=train.RunConfig(
            name=name, storage_path=str(root),
            checkpoint_config=train.CheckpointConfig(num_to_keep=2),
            failure_config=train.FailureConfig(max_failures=1)),
        **({"use_worker_actor": False} if train is jtrain else {})).fit()
    assert result.error is None
    dirs = sorted(d for d in os.listdir(result.path) if d.startswith("checkpoint_"))
    return result, dirs


def test_tiny_llama_fit_matches_jax_loop(tmp_path):
    """JAX's flax/optax loop under JaxTrainer against the port's loop under
    TorchTrainer from the same weights and batches, both failing once at
    step 3 and resuming from step 3's checkpoint."""
    jseen, tseen = {}, {}
    jres, jdirs = _fit_llama(jtrain.JaxTrainer, lambda c: jax_llama_loop(jseen, c), tmp_path,
                             "jax")
    params = jax.device_get(_jax_llama()["params"])
    tres, tdirs = _fit_llama(ttrain.TorchTrainer, lambda c: port_llama_loop(ttrain, tseen, c),
                             tmp_path, "torch", params=params)
    assert jseen["resumed_from"] == tseen["resumed_from"] == [FAIL_AT]
    steps = [m["step"] for m in tres.metrics_history]
    assert steps == [m["step"] for m in jres.metrics_history] == list(range(STEPS))
    assert [m["training_iteration"] for m in tres.metrics_history] == list(range(1, STEPS + 1))
    np.testing.assert_allclose([m["loss"] for m in tres.metrics_history],
                               [m["loss"] for m in jres.metrics_history], rtol=LOSS_RTOL)
    assert tdirs == jdirs == ["checkpoint_000004", "checkpoint_000005"]
    assert os.path.basename(tres.checkpoint.path) == os.path.basename(jres.checkpoint.path)
    assert Checkpoint.from_directory(tres.checkpoint.path).to_state()["step"] == STEPS


def test_port_loop_equal_under_both_trainers(tmp_path):
    """The port's loop under TorchTrainer and under JaxTrainer (as
    test_torch_train_resume.py runs it), each failing once at step 3:
    losses and final params torch.equal."""
    seen = {"jax": {}, "torch": {}}
    params = jax.device_get(_jax_llama()["params"])
    res = {}
    for pkg, (train, trainer_cls) in PACKAGES.items():
        res[pkg] = _fit_llama(trainer_cls, lambda c, t=train, s=seen[pkg]:
                              port_llama_loop(t, s, c), tmp_path, pkg, params=params)
    j, t = seen["jax"], seen["torch"]
    assert j["resumed_from"] == t["resumed_from"] == [FAIL_AT]
    assert sorted(t["losses"]) == list(range(STEPS))
    assert all(torch.equal(t["losses"][i], j["losses"][i]) for i in range(STEPS))
    assert t["params"].keys() == j["params"].keys()
    assert all(torch.equal(t["params"][k], v) for k, v in j["params"].items())
    assert res["torch"][0].metrics_history == res["jax"][0].metrics_history
    assert res["torch"][1] == res["jax"][1]


# ---------------------------------------------------------------- the runtime
def _make_crashy_loop():
    """test_train_orchestration.py's loop, reporting to the port's session:
    it kills its own process once at iteration `die_at`, so the resume
    comes from the actor's restart and the checkpoint on disk. Built in a
    function so that cloudpickle sends it by value."""

    def crashy_loop(config):
        import os
        from ray_tpu_torch import train
        start = 1
        ckpt = train.get_checkpoint()
        if ckpt is not None:
            start = ckpt.to_state()["it"] + 1
        for it in range(start, config["steps"] + 1):
            if it == config["die_at"] and not os.path.exists(config["flag"]):
                with open(config["flag"], "w") as f:
                    f.write("died")
                os._exit(1)
            train.report({"it": it}, checkpoint=train.Checkpoint.from_state({"it": it}))

    return crashy_loop


def test_train_worker_actor_resumes_after_kill(ray_session, tmp_path):
    loop = _make_crashy_loop()
    config = {"steps": 6, "die_at": 4, "flag": str(tmp_path / "died_once")}
    Worker = ray_session.remote(num_cpus=1, max_restarts=2, max_task_retries=2)(twg.TrainWorker)
    worker = Worker.remote(cloudpickle.dumps(loop), config, ttrain.ScalingConfig(),
                           ttrain.RunConfig(name="crash", storage_path=str(tmp_path)), {},
                           None, "run-crash", device="cpu")
    try:
        killed = ttrain.Result.from_run(ray_session.get(worker.run.remote(), timeout=240))
    finally:
        ray_session.kill(worker)
    assert os.path.exists(config["flag"]), "loop never reached the crash point"
    whole = ttrain.TorchTrainer(
        loop, train_loop_config=dict(config, die_at=None),
        run_config=ttrain.RunConfig(name="whole", storage_path=str(tmp_path))).fit()
    assert killed.error is None and whole.error is None
    assert [m["it"] for m in killed.metrics_history] == [1, 2, 3, 4, 5, 6]
    assert killed.metrics_history == whole.metrics_history
    assert killed.checkpoint.to_state() == whole.checkpoint.to_state() == {"it": 6}
    assert sorted(os.listdir(killed.path)) == sorted(os.listdir(whole.path))
