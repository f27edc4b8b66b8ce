"""Serve's deployment layer: `ray_tpu_torch.serve` against `ray_tpu.serve`
on the same programs, on the CPU.

- Pure functions, no session: the autoscaler's decisions
  (`decide_num_replicas`, `decide_num_replicas_slo`, `aggregate_slo`), the
  multiplex pin rebalance, the router's prefix-affinity scoring and its
  spill and escape hatch, `@serve.batch` coalescing, timeout flush and
  error propagation: the same inputs through both packages, equal answers.
- A session of each runtime (JAX's `ray_session`, the port's
  `rt.init(num_gpus=0)`): each program of `tests/test_serve.py` (end to
  end, composition, streaming, a function deployment and `user_config`,
  batching, autoscaling up, redeploy, replica context and app handle,
  `run_many` / `shutdown_async`) and of `tests/test_serve_fleet.py` (the
  digest piggyback routing to its advertiser, the died-replica reroute,
  the multiplex pin rebalance) written once against a `serve` module and
  run on both, answers equal.
- The port's own: `__all__` name for name, the serve controller's and the
  HTTP proxy's processes load no torch, `import ray_tpu_torch.serve`
  loads nothing; a bound deployment nested in a dict or list argument
  becomes a handle (JAX's walk sees top-level arguments only); a
  `num_gpus=1` replica's card returns to the runtime when its app is
  deleted (JAX's runtime loses the id of an actor created from a worker,
  so this case runs on the port only); handles derived by `options()` or
  `handle.method` share one routing state, so p2c counts every request
  in flight (JAX's refresh rebinds a derived handle's own copy).
"""

import asyncio
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

import ray_tpu
import ray_tpu.serve as jserve
import ray_tpu_torch as rt
import ray_tpu_torch.serve as tserve
from ray_tpu.serve import batching as jbatching
from ray_tpu.serve import controller as jctl
from ray_tpu.serve import handle as jhandle
from ray_tpu.serve import multiplex as jmux
from ray_tpu.serve import prefix_digest as jpd
from ray_tpu_torch.serve import batching as tbatching
from ray_tpu_torch.serve import controller as tctl
from ray_tpu_torch.serve import handle as thandle
from ray_tpu_torch.serve import multiplex as tmux
from ray_tpu_torch.serve import prefix_digest as tpd

REPO = Path(__file__).resolve().parents[1]
PKG = {"jax": (jctl, jhandle, jpd, jmux, jbatching), "port": (tctl, thandle, tpd, tmux, tbatching)}


def _both(fn):
    """fn(pkg modules) for JAX's and the port's: (want, got)."""
    return fn(*PKG["jax"]), fn(*PKG["port"])


# ------------------------------------------------------------- pure functions
AUTO = [dict(min_replicas=1, max_replicas=10, target_ongoing_requests=2.0),
        dict(min_replicas=0, max_replicas=5, target_ongoing_requests=2.0),
        dict(min_replicas=2, max_replicas=3, target_ongoing_requests=0.5)]


@pytest.mark.parametrize("ongoing,cur", [(0, 3), (6, 3), (20, 3), (5, 2), (100, 0), (0, 0),
                                         (0, 1), (2.5, 1)])
@pytest.mark.parametrize("auto", range(len(AUTO)))
def test_decide_num_replicas_matches_jax(ongoing, cur, auto):
    want = jctl.decide_num_replicas(ongoing, cur, jserve.AutoscalingConfig(**AUTO[auto]))
    got = tctl.decide_num_replicas(ongoing, cur, tserve.AutoscalingConfig(**AUTO[auto]))
    assert got == want


SLO_CASES = [  # (ongoing, current, autoscaling kwargs, fleet snapshot)
    (2, 2, dict(target_ttft_p99_s=0.5), {"ttft_p99_s": 1.2}),
    (2, 8, dict(target_ttft_p99_s=0.5), {"ttft_p99_s": 1.2}),
    (0, 2, dict(target_tpot_p99_ms=20.0), {"tpot_p99_ms": 80.0}),
    (2, 2, {}, {"occupancy_mean": 0.95}),
    (1, 4, dict(target_ttft_p99_s=1.0), {"ttft_p99_s": 0.9}),
    (1, 4, dict(target_ttft_p99_s=1.0), {"ttft_p99_s": 0.2}),
    (1, 4, dict(target_ttft_p99_s=1.0), None),
    (3, 0, dict(target_ttft_p99_s=1.0), {"ttft_p99_s": 5.0}),
    (1, 3, dict(target_tpot_p99_ms=10.0, downscale_slo_margin=0.8), {"tpot_p99_ms": 7.0}),
]


@pytest.mark.parametrize("case", range(len(SLO_CASES)))
def test_decide_num_replicas_slo_matches_jax(case):
    ongoing, cur, kw, slo = SLO_CASES[case]
    kw = dict(dict(min_replicas=1, max_replicas=8, target_ongoing_requests=2.0), **kw)
    want = jctl.decide_num_replicas_slo(ongoing, cur, jserve.AutoscalingConfig(**kw), slo)
    got = tctl.decide_num_replicas_slo(ongoing, cur, tserve.AutoscalingConfig(**kw), slo)
    assert got == want


@pytest.mark.parametrize("frames", [
    [{"ttft_p99_s": 0.1, "tpot_p99_ms": 5.0, "occupancy_mean": 0.2},
     {"ttft_p99_s": 0.9, "tpot_p99_ms": None, "occupancy_mean": 0.6}, None],
    [], [None], [{"ttft_p99_s": None, "occupancy_mean": None}],
    [{"ttft_p99_s": 0.3, "tpot_p99_ms": 9.0, "occupancy_mean": 1.0}] * 3,
])
def test_aggregate_slo_matches_jax(frames):
    assert tctl.aggregate_slo(frames) == jctl.aggregate_slo(frames)


@pytest.mark.parametrize("vec,idx", [([10, 1], 0), ([3, 3], 0), ([1, 0], 0), ([5], 0),
                                     ([9, 2, 1], 0), ([4, 2, 3], 0), ([0, 7, 1], 1),
                                     ([2, 2], 5)])
def test_should_rebalance_pin_matches_jax(vec, idx):
    assert tmux.should_rebalance_pin(vec, idx) == jmux.should_rebalance_pin(vec, idx)


PS = 4  # tokens a page in the router's digests


def _prompt(*pages, tail=1):
    toks = []
    for p in pages:
        toks.extend(range(p * 100, p * 100 + PS))
    return toks + list(range(9000, 9000 + tail))


def _family_digest(pd, tokens, hits=10):
    hashes = pd.prompt_chain_hashes(tokens, PS)
    return pd.build([(h, hits, i + 1) for i, h in enumerate(hashes)], PS)


def _fake_handle(handle_mod, n, digests):
    h = handle_mod.DeploymentHandle("d")
    h._replicas = [f"r{i}" for i in range(n)]
    h._inflight = {i: 0 for i in range(n)}
    h._digests = digests
    return h


def test_router_affinity_scoring_matches_jax(monkeypatch):
    """score_replicas and the handle's deepest-match pick, its spill back to
    p2c and the RAY_TPU_PREFIX_AFFINITY=0 hatch, on the same digests."""
    fam_a, fam_b, other = _prompt(1, 2, 3), _prompt(5, 6, 7), _prompt(11, 12, 13)

    def run(ctl, handle, pd, mux, batching):
        dg = {0: _family_digest(pd, fam_a), 1: _family_digest(pd, _prompt(1, tail=0)),
              2: _family_digest(pd, fam_b)}
        h = _fake_handle(handle, 3, dg)
        out = dict(scores=[pd.score_replicas(dg, p) for p in (fam_a, fam_b, other)],
                   picks=[h._pick_by_prefix(p) for p in (fam_a, fam_b, other)],
                   token_seq=[handle._token_seq(x) is not None
                              for x in ([1, 2], [True], [], "ab", [1.5], (3,))])
        h._inflight = {0: pd.spill_threshold() + 1, 1: 0, 2: 0}
        out["spilled"] = h._pick_by_prefix(fam_a)
        h._inflight = {0: 1, 1: 0, 2: 0}
        out["near"] = h._pick_by_prefix(fam_a)
        monkeypatch.setenv("RAY_TPU_PREFIX_AFFINITY", "0")
        out["hatch"] = pd.affinity_enabled()
        monkeypatch.delenv("RAY_TPU_PREFIX_AFFINITY")
        out["packed"] = pd.pack(dg[0])
        return out

    want, got = _both(run)
    assert got == want
    assert got["picks"] == [0, 2, None] and got["spilled"] is None and got["near"] == 0


def test_router_p2c_prefers_less_loaded():
    """p2c on the handle's in-flight counts: replica 1 wins every draw it is in."""
    for handle in (jhandle, thandle):
        h = _fake_handle(handle, 3, {})
        h._inflight = {0: 10, 1: 0, 2: 10}
        assert [h._pick_replica() for _ in range(60)].count(1) > 20


def _batch_program(batching, scenario):
    calls = []
    if scenario == "coalesce":
        @batching.batch(max_batch_size=4, batch_wait_timeout_s=0.05)
        async def handler(items):
            calls.append(sorted(items))
            return [i * 10 for i in items]
        args = range(4)
    elif scenario == "timeout":
        @batching.batch(max_batch_size=100, batch_wait_timeout_s=0.02)
        async def handler(items):
            calls.append(sorted(items))
            return [i + 1 for i in items]
        args = (1, 2)
    else:
        @batching.batch(max_batch_size=2, batch_wait_timeout_s=0.01)
        async def handler(items):
            calls.append(sorted(items))
            raise RuntimeError("bad batch")
        args = (1, 2)

    async def main():
        return await asyncio.gather(*[handler(i) for i in args], return_exceptions=True)

    out = asyncio.run(main())
    return [repr(o) if isinstance(o, Exception) else o for o in out], calls


@pytest.mark.parametrize("scenario", ["coalesce", "timeout", "error"])
def test_batch_matches_jax(scenario):
    want, got = _batch_program(jbatching, scenario), _batch_program(tbatching, scenario)
    assert got == want
    assert len(got[1]) == 1     # one call: by size, by the timer, or raising for both


def test_multiplex_lease_spares_in_use_models():
    """The LRU defers evicting a model a live request holds, in both."""
    def run(cache_cls):
        unloaded = []

        class Model:
            def __init__(self, mid):
                self.mid = mid

            def unload(self):
                unloaded.append(self.mid)

        async def scenario():
            cache = cache_cls(lambda owner, mid: Model(mid), max_models=1)
            go = asyncio.Event()

            async def hold(mid):
                m = await cache.get_model(None, mid)
                await go.wait()
                return m.mid

            t1 = asyncio.ensure_future(hold("A"))
            await asyncio.sleep(0.05)
            t2 = asyncio.ensure_future(hold("B"))
            await asyncio.sleep(0.05)
            during = (list(unloaded), sorted(cache.models))
            go.set()
            done = await asyncio.gather(t1, t2)
            await asyncio.sleep(0.05)
            return during, done, list(unloaded), list(cache.models)

        return asyncio.run(scenario())

    got, want = run(tmux._ModelCache), run(jmux._ModelCache)
    assert got == want and got[0] == ([], ["A", "B"])


def test_all_names_match_jax():
    assert tserve.__all__ == jserve.__all__
    light = [n for n in tserve.__all__ if tserve._LAZY.get(n) not in (".openai_api", ".pd")]
    for name in light:
        assert getattr(tserve, name).__name__ == getattr(jserve, name).__name__, name


def test_import_loads_no_torch():
    """`import ray_tpu_torch.serve` and its deployment layer load no torch;
    the engine names load it on first use."""
    code = ("import sys; import ray_tpu_torch.serve as s; "
            "from ray_tpu_torch.serve import api, controller, handle, proxy, replica, schema, asgi; "
            "s.deployment; s.run; s.Request; s.batch; s.ingress; "
            "a = 'torch' in sys.modules; s.ByteTokenizer; b = 'torch' in sys.modules; "
            "print(a, b, 'jax' in sys.modules, 'ray_tpu' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=120, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "True", "False", "False"]


# ------------------------------------------------------------------ sessions
@pytest.fixture(scope="module")
def port_session():
    """The port's session for a module: one "GPU" number (no card on this
    box); its workers run torch on one intra-op thread, as several test
    processes share the box's cores."""
    threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    rt.init(num_cpus=4, num_gpus=1)
    yield rt
    tserve.shutdown()
    rt.shutdown()
    if threads is None:
        os.environ.pop("OMP_NUM_THREADS")
    else:
        os.environ["OMP_NUM_THREADS"] = threads


@pytest.fixture(scope="module")
def sessions(ray_session, port_session):
    yield {"jax": (ray_tpu, jserve), "port": (rt, tserve)}
    jserve.shutdown()


def _on_both(sessions, program):
    want = program(*sessions["jax"])
    got = program(*sessions["port"])
    assert got == want
    return got


def test_deployment_end_to_end(sessions):
    def program(rt_, serve):
        @serve.deployment(num_replicas=2)
        class Doubler:
            def __call__(self, x):
                return x * 2

            def plus(self, x, y=0):
                return x + y

        h = serve.run(Doubler.bind(), name="e2e")
        out = [h.remote(21).result(timeout_s=60),
               h.options(method_name="plus").remote(1, y=2).result(timeout_s=60),
               h.plus.remote(5, y=5).result(timeout_s=60), serve.status()["e2e:Doubler"]]
        serve.delete("e2e")
        return out

    assert _on_both(sessions, program) == [42, 3, 10, {"replicas": 2}]


def test_composition_handle_in_deployment(sessions):
    def program(rt_, serve):
        @serve.deployment
        class Adder:
            def __init__(self, offset):
                self.offset = offset

            def __call__(self, x):
                return x + self.offset

        @serve.deployment
        class Ingress:
            def __init__(self, adder):
                self.adder = adder

            async def __call__(self, x):
                return (await self.adder.remote(x)) * 10

        h = serve.run(Ingress.bind(Adder.bind(7)), name="comp")
        out = h.remote(3).result(timeout_s=60)
        serve.delete("comp")
        return out

    assert _on_both(sessions, program) == 100


def test_streaming_deployment(sessions):
    def program(rt_, serve):
        @serve.deployment
        class Streamer:
            def stream(self, n):
                for i in range(n):
                    yield i * i

            async def astream(self, n):
                for i in range(n):
                    await asyncio.sleep(0)
                    yield {"i": i}

        h = serve.run(Streamer.bind(), name="stream")
        out = [list(h.options(method_name="stream", stream=True).remote(4)),
               list(h.options(method_name="astream", stream=True).remote(3))]
        serve.delete("stream")
        return out

    assert _on_both(sessions, program)[0] == [0, 1, 4, 9]


def test_function_deployment_and_user_config(sessions):
    def program(rt_, serve):
        @serve.deployment
        def square(x):
            return x * x

        @serve.deployment(user_config={"scale": 3})
        class Scaled:
            def __init__(self):
                self.scale = 1

            def reconfigure(self, cfg):
                self.scale = cfg["scale"]

            def __call__(self, x):
                return x * self.scale

        out = [serve.run(square.bind(), name="fn").remote(9).result(timeout_s=60),
               serve.run(Scaled.bind(), name="ucfg").remote(5).result(timeout_s=60),
               serve.run(Scaled.options(user_config={"scale": 7}).bind(),
                         name="ucfg").remote(5).result(timeout_s=60)]
        serve.delete("fn")
        serve.delete("ucfg")
        return out

    assert _on_both(sessions, program) == [81, 15, 35]


def test_batched_deployment(sessions):
    def program(rt_, serve):
        @serve.deployment
        class Batched:
            def __init__(self):
                self.sizes = []

            @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.1)
            async def handle_batch(self, items):
                self.sizes.append(len(items))
                return [i + 100 for i in items]

            async def __call__(self, x):
                return await self.handle_batch(x)

            def get_sizes(self):
                return self.sizes

        h = serve.run(Batched.bind(), name="batched")
        results = sorted(r.result(timeout_s=60) for r in [h.remote(i) for i in range(8)])
        coalesced = max(h.get_sizes.remote().result(timeout_s=60)) > 1
        serve.delete("batched")
        return results, coalesced

    assert _on_both(sessions, program) == ([100 + i for i in range(8)], True)


def test_autoscaling_scales_up(sessions):
    def program(rt_, serve):
        @serve.deployment(autoscaling_config={"min_replicas": 1, "max_replicas": 3,
                                              "target_ongoing_requests": 1})
        class Slow:
            async def __call__(self):
                await asyncio.sleep(1.0)
                return "ok"

        ctl = (jctl if serve is jserve else tctl).get_controller()
        h = serve.run(Slow.bind(), name="auto", _autoscale_interval_s=0.3)
        responses = [h.remote() for _ in range(6)]
        deadline, n = time.time() + 30, 1
        while time.time() < deadline and n == 1:
            n = rt_.get(ctl.num_replicas.remote("auto", "Slow"))
            time.sleep(0.3)
        out = [r.result(timeout_s=60) for r in responses]
        events = {e["action"] for e in rt_.get(ctl.scale_events.remote())}
        serve.delete("auto")
        return n > 1, out, "scale_up" in events

    assert _on_both(sessions, program) == (True, ["ok"] * 6, True)


def test_redeploy_same_app(sessions):
    def program(rt_, serve):
        @serve.deployment
        class V:
            def __init__(self, v):
                self.v = v

            def __call__(self):
                return self.v

        out = [serve.run(V.bind(1), name="redeploy").remote().result(timeout_s=60),
               serve.run(V.bind(2), name="redeploy").remote().result(timeout_s=60)]
        serve.delete("redeploy")
        return out

    assert _on_both(sessions, program) == [1, 2]


def test_replica_context_and_app_handle(sessions):
    def program(rt_, serve):
        @serve.deployment
        class WhoAmI:
            def __init__(self):
                self.ctx = serve.get_replica_context()

            def __call__(self):
                ctx = serve.get_replica_context()
                return ctx.app_name, ctx.deployment, ctx.replica_tag, self.ctx.replica_tag

        serve.run(WhoAmI.bind(), name="whoami")
        out = [tuple(serve.get_app_handle("whoami").remote().result(timeout_s=60))]
        for call, arg in ((serve.get_app_handle, "nope"), (serve.get_replica_context, None)):
            try:
                call(arg) if arg else call()
            except (ValueError, RuntimeError) as e:
                out.append((type(e).__name__, str(e)))
        serve.delete("whoami")
        return out

    got = _on_both(sessions, program)
    assert got[0] == ("whoami", "WhoAmI", "WhoAmI#0", "WhoAmI#0")
    assert [e[0] for e in got[1:]] == ["ValueError", "RuntimeError"]


def test_digest_piggyback_routes_to_advertiser(sessions):
    """Each of two replicas advertises one prompt family through the stats
    piggyback (replica -> controller cache -> handle refresh); requests
    carrying a family's tokens land on its advertiser."""
    fams = [list(range(0, 32)), list(range(500, 532))]

    def program(rt_, serve):
        pd = jpd if serve is jserve else tpd

        @serve.deployment(num_replicas=2)
        class Advertiser:
            def __init__(self):
                self._idx = int(serve.get_replica_context().replica_tag.rsplit("#", 1)[1]) % 2

            def prefix_digest(self):
                hashes = pd.prompt_chain_hashes(fams[self._idx], 8)
                return pd.build([(h, 10, i + 1) for i, h in enumerate(hashes)], 8)

            def which(self, tokens):
                return self._idx

        hw = serve.run(Advertiser.bind(), name="adv").options(method_name="which")
        hw._refresh(force=True)
        out = [sorted(hw._digests)]
        for idx in (0, 1):
            out.append({hw.remote(list(fams[idx])).result(timeout_s=60) for _ in range(6)})
        serve.delete("adv")
        return out

    assert _on_both(sessions, program) == [[0, 1], {0}, {1}]


def test_mux_pin_rebalances_off_hot_replica(sessions):
    def program(rt_, serve):
        metrics = (sys.modules["ray_tpu.util.metrics"] if serve is jserve
                   else sys.modules["ray_tpu_torch.util.metrics"])

        @serve.deployment(num_replicas=2)
        class Mux:
            def echo(self, x):
                return x

        h = serve.run(Mux.bind(), name="mux-reb")
        mh = h.options(method_name="echo", multiplexed_model_id="lora-A")
        mh._refresh(force=True)
        before = metrics.serve_fleet_counters()["mux_rebalances"]
        with mh._lock:
            mh._model_affinity["lora-A"] = 0
            mh._inflight = {0: 10, 1: 1}
        out = [mh.remote(7).result(timeout_s=60), mh._model_affinity["lora-A"],
               metrics.serve_fleet_counters()["mux_rebalances"] - before]
        serve.delete("mux-reb")
        return out

    import ray_tpu.util.metrics  # noqa: F401 - both registries loaded by name
    import ray_tpu_torch.util.metrics  # noqa: F401
    assert _on_both(sessions, program) == [7, 1, 1]


def test_replica_death_reroutes_to_survivor(sessions):
    """SIGKILL one replica's process; a request pinned into the corpse is
    retried on the survivor, the pin evicted, the corpse pruned."""
    def program(rt_, serve):
        ctl_mod = jctl if serve is jserve else tctl

        @serve.deployment(num_replicas=2)
        class Victim:
            def echo(self, x):
                return x * 2

        h = serve.run(Victim.bind(), name="death")
        ctrl = ctl_mod.get_controller()
        reps = rt_.get(ctrl.get_replicas.remote("death", "Victim"))
        pids = [rt_.get(r.stats.remote(), timeout=30)["pid"] for r in reps]
        he = h.options(method_name="echo")
        he._refresh(force=True)
        dead_id = reps[0]._actor_id
        dead_idx = next(i for i, r in enumerate(he._replicas) if r._actor_id == dead_id)
        os.kill(pids[0], signal.SIGKILL)
        time.sleep(0.2)
        hm = h.options(method_name="echo", multiplexed_model_id="m0")
        hm._refresh(force=True)
        with hm._lock:
            hm._model_affinity["m0"] = dead_idx
        out = [pids[0] != pids[1] != os.getpid(), hm.remote(21).result(timeout_s=60),
               hm._model_affinity.get("m0") != dead_idx,
               [he.remote(1).result(timeout_s=60) for _ in range(5)],
               rt_.get(ctrl.num_replicas.remote("death", "Victim"))]
        serve.delete("death")
        return out

    assert _on_both(sessions, program) == [True, 42, True, [2] * 5, 1]


def test_nested_bound_deployments_become_handles(sessions):
    @tserve.deployment
    class Adder:
        def __init__(self, k):
            self.k = k

        def __call__(self, x):
            return x + self.k

    @tserve.deployment
    class Fan:
        def __init__(self, by_name, chain):
            self.by_name, self.chain = by_name, chain

        async def __call__(self, x):
            one = await self.by_name["one"].remote(x)
            for h in self.chain:
                one = await h.remote(one)
            return one

    h = tserve.run(Fan.bind({"one": Adder.bind(1)}, [Adder.options(name="A10").bind(10),
                                                     Adder.options(name="A100").bind(100)]),
                   name="nested")
    assert h.remote(5).result(timeout_s=60) == 116
    assert sorted(tserve.status()) == ["nested:A10", "nested:A100", "nested:Adder", "nested:Fan"]
    tserve.delete("nested")


def test_gpu_replica_card_returns_after_delete(sessions):
    """A num_gpus=1 replica holds the session's one card id; deleting its
    app frees it for the next replica (the replica is created by the serve
    controller, a worker)."""
    @tserve.deployment(ray_actor_options={"num_gpus": 1})
    class Holder:
        def __call__(self):
            return rt.get_gpu_ids(), os.environ.get("CUDA_VISIBLE_DEVICES")

    got = []
    for _ in range(2):
        got.append(tuple(tserve.run(Holder.bind(), name="card").remote().result(timeout_s=60)))
        tserve.delete("card")
    assert got == [([0], "0"), ([0], "0")]
    assert rt.available_resources().get("GPU") == 1


def test_derived_handles_share_the_p2c_counts(sessions):
    """Four slow requests through `handle.tag.remote()` spread two and two
    over two replicas, the parent handle holding the refreshed replica set
    and the counts of all four while they run."""
    @tserve.deployment(num_replicas=2)
    class Slow:
        async def tag(self):
            await asyncio.sleep(0.5)
            return tserve.get_replica_context().replica_tag

    h = tserve.run(Slow.bind(), name="p2c")
    for _ in range(3):
        resps = [h.tag.remote() for _ in range(4)]
        in_flight = sorted(h._inflight.values())
        tags = sorted(r.result(timeout_s=60) for r in resps)
        assert in_flight == [2, 2] and len(h._replicas) == 2
        assert tags == ["Slow#0", "Slow#0", "Slow#1", "Slow#1"]
    tserve.delete("p2c")


def _actor_pid(name):
    """The pid of the port's named actor's worker, from the driver's runtime."""
    aid = rt.get_actor(name)._actor_id
    workers = rt.api._runtime.controller.workers.values()
    return next(w.proc.pid for w in workers if w.actor_id == aid and w.proc is not None)


def test_controller_and_proxy_load_no_torch(sessions):
    """The port's serve controller and HTTP proxy run in processes without
    torch, while a deployment of the port's LLM config is registered
    (its arguments stay pickled bytes there)."""
    from ray_tpu_torch.serve.llm import LLMConfig

    @tserve.deployment
    class Holder:
        def __init__(self, cfg):
            self.cfg = cfg

        def __call__(self):
            return self.cfg.preset

    h = tserve.run(Holder.bind(LLMConfig(preset="tiny", device="cpu")), name="holder",
                   route_prefix="/holder")
    tserve.start(http_options={"port": 0})
    assert h.remote().result(timeout_s=60) == "tiny"
    for name in ("SERVE_CONTROLLER", "SERVE_PROXY"):
        maps = Path(f"/proc/{_actor_pid(name)}/maps").read_text()
        assert "libtorch" not in maps and "jaxlib" not in maps, name
    tserve.delete("holder")


def test_run_many_and_shutdown_async(sessions):
    def program(rt_, serve):
        @serve.deployment
        def alpha():
            return "a"

        @serve.deployment
        def beta():
            return "b"

        h1, h2 = serve.run_many([("many_a", alpha.bind()), ("many_b", beta.bind())])
        out = [h1.remote().result(timeout_s=60), h2.remote().result(timeout_s=60)]
        port = serve.start(http_options=serve.HTTPOptions(port=0))
        out.append(isinstance(port, int) and port > 0)
        out.append(sorted(serve.status()))

        async def drive():
            await serve.shutdown_async()

        asyncio.run(drive())
        out.append(serve.status())
        return out

    assert _on_both(sessions, program) == ["a", "b", True, ["many_a:alpha", "many_b:beta"], {}]
