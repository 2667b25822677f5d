"""Serving a searched plan across ranks: `ServingProgram(machine_mesh=...,
mapping=...)` and `ServingEngine` on 2 and 4 gloo ranks against the JAX
package's searched `ServingProgram` on as many virtual CPU devices and the
port's single-device program, at the JAX serving tests' sizes
(`ServingLMConfig()`: vocab 64, hidden 32, 4 heads, 2 layers; 4 slots, 24
positions, prompts of 5).

Plans: the winner of the serving search for 2 and for 4 devices
(`optimize_serving_plan` on the analytic estimators, the JAX package's CPU
constants; at these sizes both packages pick the serial plan), the forced
tp2 plan (heads and the FFN cut in 2) and the forced dp2 x tp2 plan (slots
and heads cut; the JAX reference is its single-device program there, see
JAX_MESHLESS). Each reaches the ranks as a
strategy file the port writes, the parameters (one seeded draw, keyed by
weight ordinal) as numpy arrays, which every rank cuts into its pieces.

Per plan and rank: the cache's partition specs and each rank's allocated
cache bytes (exactly `per_device_cache_bytes` of the plan); the prefill's
last-position logits within 1e-5 relative of the JAX program's and the
single-device port's; six greedy decode steps equal to both (under the
forced plans the logits stay cut over their classes, and the greedy token
is the argmax across class shards); and the
engine's trace (each window's admissions, every request's tokens) over 10
seeded requests equal on every rank and to the single-device engine's.
The window runs eagerly under gloo (`last_window["captured"]` False).

Supervision over ranks: two tp2 replicas over the 2-rank group under a
seeded FF_TPU_FAULT_SPEC hang (one firing): rank 0's watchdog times the
hang and broadcasts the shed, so both ranks shed the same replica at the
same window, and every request completes with the single-device tokens;
and a background fault posted on rank 0's FaultChannel alone is shed on
every rank at the next window boundary."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flexflow_tpu.compiler.unity_algorithm import parallel_degree_summary as j_summary
from flexflow_tpu.parallel.mesh import MachineMesh as JaxMesh
from flexflow_tpu.pcg.machine_view import MachineSpecification as JSpec
from flexflow_tpu.runtime.strategy import load_strategy as jax_load_strategy
from flexflow_tpu.serving import ServingLMConfig as JCfg
from flexflow_tpu.serving import ServingProgram as JaxProgram
from flexflow_tpu.serving import build_serving_lm as j_build
from flexflow_tpu.serving.plan import ServingWorkload as JWorkload
from flexflow_tpu.serving.plan import optimize_serving_plan as j_optimize
from flexflow_tpu_torch.compiler import parallel_degree_summary as t_summary
from flexflow_tpu_torch.compiler.unity_algorithm import data_parallel_seed, tensor_parallel_seed
from flexflow_tpu_torch.pcg.machine_view import MachineSpecification as TSpec
from flexflow_tpu_torch.pcg.parallel_computation_graph import pcg_from_computation_graph
from flexflow_tpu_torch.runtime.fault import FaultSchedule
from flexflow_tpu_torch.runtime.strategy import save_strategy
from flexflow_tpu_torch.serving import ServingLMConfig, ServingProgram, build_serving_lm
from flexflow_tpu_torch.serving.plan import ServingWorkload, optimize_serving_plan
from flexflow_tpu_torch.serving.program import init_serving_params
from test_torch_port_once import once_per_session

REPO = Path(__file__).resolve().parent.parent
SLOTS, SEQ_CAP, PROMPT, STEPS = 4, 24, 5, 6
PLANS = {"searched2": 2, "tp2": 2, "searched4": 4, "dp2xtp2": 4}
WORKLOAD = dict(prompt_len=PROMPT, gen_len=8, max_concurrent=SLOTS)
# plans the JAX package's program cannot lower over its mesh: under dp x tp
# its axis assignment puts the column-parallel weights' head shards on the
# batch axis, so its cache binding gives slots and heads one axis (a
# duplicate PartitionSpec). The JAX reference there is its single-device
# program of the plan; the port binds the cache to the axes the attention
# op receives after its operand reshards.
JAX_MESHLESS = {"dp2xtp2"}


def _builder(b, s):
    return build_serving_lm(ServingLMConfig(), b, s)


def _plan(name):
    """(port PCG, port mapping, JAX search winner or None)."""
    n = PLANS[name]
    if name.startswith("searched"):
        tp = optimize_serving_plan(_builder, TSpec(1, 1, n, 1.0, 2.0), ServingWorkload(**WORKLOAD),
                                   budget=2, max_seq_len=SEQ_CAP, device="cpu")
        jp = j_optimize(lambda b, s: j_build(JCfg(), b, s), JSpec(1, 1, n, 1.0, 2.0),
                        JWorkload(**WORKLOAD), budget=2, max_seq_len=SEQ_CAP)
        return tp.decode.pcg, tp.decode.machine_mapping, (tp, jp)
    pcg = tensor_parallel_seed(pcg_from_computation_graph(_builder(SLOTS, 1)[0]), 2)
    if name == "dp2xtp2":
        pcg = data_parallel_seed(pcg, 2)
    return pcg, None, None


def _requests():
    rng = np.random.default_rng(7)
    return [(f"r{i}", rng.integers(0, 64, PROMPT).astype(np.int32).tolist(),
             int(rng.integers(2, 10))) for i in range(10)]


def _shed_requests():
    """Eight requests of 13 tokens (the prefill's and four windows of
    three): the two replicas' third windows run three steps again, so they
    are armed with a budget."""
    rng = np.random.default_rng(8)
    return [(f"s{i}", rng.integers(0, 64, PROMPT).astype(np.int32).tolist(), 13)
            for i in range(8)]


def _hang_seed(lo, hi, horizon, rate):
    """A schedule seed whose "hang" site fires once, in window [lo, hi]."""
    for seed in range(100000):
        fired = FaultSchedule(seed=seed, sites=frozenset({"hang"}), rate=rate).fire_steps(
            "hang", 1, horizon)
        if len(fired) == 1 and lo <= fired[0] <= hi:
            return seed
    raise AssertionError("no single-firing hang seed")


# One rank; argv: rank, world, work dir. Serves each plan of the world.
WORKER = textwrap.dedent(
    """
    import json, os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from flexflow_tpu_torch.parallel import MachineMesh, init_file_group
    from flexflow_tpu_torch.runtime.strategy import load_strategy
    from flexflow_tpu_torch.serving import ServeRequest, ServingEngine, ServingProgram
    from flexflow_tpu_torch.serving.kv_cache import ServingMemorySpec, per_device_cache_bytes

    torch.set_num_threads(1)
    rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    init_file_group(os.path.join(work, "store"), rank, world, device="cpu")
    cfg = json.load(open(os.path.join(work, "config.json")))
    mem = ServingMemorySpec(cfg["slots"], cfg["seq_cap"])
    params = dict(np.load(os.path.join(work, "params.npz")))
    prompts, lengths = np.array(cfg["prompts"], np.int32), np.array(cfg["lengths"], np.int32)

    def engine(programs, requests=cfg["requests"], **kw):
        eng = ServingEngine(programs, mode="continuous", window_steps=3, **kw)
        trace = []
        prefill = eng._prefill
        eng._prefill = lambda rep, adm: trace.append(
            [eng.windows, rep.idx, [rep.slots[i].request.rid for i in adm]]) or prefill(rep, adm)
        sheds = []
        shed = eng._shed
        eng._shed = lambda rep, e: sheds.append([eng.windows, rep.idx]) or shed(rep, e)
        for rid, prompt, n in requests:
            eng.submit(ServeRequest(rid, np.array(prompt, np.int32), n))
        try:
            recs = eng.run()
        finally:
            eng.close()
        return dict(trace=trace, sheds=sheds, tokens={r.rid: r.tokens for r in recs},
                    replica_sheds=eng.replica_sheds)

    out = {}
    for plan in cfg["plans"]:
        pcg, mapping, _ = load_strategy(os.path.join(work, plan + ".json"))
        mesh = MachineMesh.for_devices(world)
        prog = ServingProgram(pcg, mem, mapping=mapping, machine_mesh=mesh,
                              params={k: torch.tensor(v) for k, v in params.items()},
                              device="cpu")
        cache = prog.init_cache()
        nbytes = sum(t.numel() * t.element_size() for kv in cache.values() for t in kv.values())
        cache, tok, last = prog.prefill(cache, prompts, lengths, np.ones(len(lengths), bool))
        _, _, _, toks = prog.decode_window(cache, tok.numpy(), lengths,
                                           np.ones(len(lengths), bool), cfg["steps"])
        out[plan] = dict(
            cache_bytes=nbytes, priced=per_device_cache_bytes(prog.pcg, prog.layers, mem),
            specs={k: [list(a) if a else None for a in v] for k, v in prog.cache_shardings.items()},
            whole=len(prog.plan.whole_nodes), last=last.numpy().tolist(),
            class_cut=bool(prog.plan.shardings[prog.logit_tensor].dims[-1]),
            tokens=toks.numpy().tolist(), captured=prog.last_window["captured"],
            engine=engine(prog))
        if plan == cfg["shed_plan"]:
            os.environ["FF_TPU_FAULT_SPEC"] = cfg["fault_spec"]
            replicas = [ServingProgram(pcg, mem, mapping=mapping, machine_mesh=mesh,
                                       params={k: torch.tensor(v) for k, v in params.items()},
                                       device="cpu") for _ in range(2)]
            out[plan]["shed"] = engine(replicas, cfg["shed_requests"], watchdog_factor=2.0,
                                       watchdog_min_budget_ms=500.0)
            del os.environ["FF_TPU_FAULT_SPEC"]
            # a background fault posted on rank 0's channel alone at window 2
            replicas = [ServingProgram(pcg, mem, mapping=mapping, machine_mesh=mesh,
                                       params={k: torch.tensor(v) for k, v in params.items()},
                                       device="cpu") for _ in range(2)]
            original = ServingEngine._window

            def window(self):
                if rank == 0 and self.windows == 1:
                    self.channel.post("prefetch", RuntimeError("injected"))
                return original(self)

            ServingEngine._window = window
            out[plan]["fault"] = engine(replicas, cfg["shed_requests"])
            ServingEngine._window = original
    json.dump(out, open(os.path.join(work, f"rank{rank}.json"), "w"))
    dist.destroy_process_group()
    """
)


def _single(params, prompts, lengths):
    """The port's single-device program and engine at the same parameters."""
    import torch

    from flexflow_tpu_torch.serving import ServeRequest, ServingEngine
    from flexflow_tpu_torch.serving.kv_cache import ServingMemorySpec

    mem = ServingMemorySpec(SLOTS, SEQ_CAP)
    prog = ServingProgram(_builder(SLOTS, 1)[0], mem, device="cpu",
                          params={k: torch.tensor(v) for k, v in params.items()})
    cache, tok, last = prog.prefill(prog.init_cache(), prompts, lengths, np.ones(SLOTS, bool))
    _, _, _, toks = prog.decode_window(cache, tok.numpy(), lengths, np.ones(SLOTS, bool), STEPS)
    runs = []
    for requests in (_requests(), _shed_requests()):
        eng = ServingEngine(prog, mode="continuous", window_steps=3)
        trace = []
        prefill = eng._prefill
        eng._prefill = lambda rep, adm, eng=eng, trace=trace: trace.append(
            [eng.windows, rep.idx, [rep.slots[i].request.rid for i in adm]]) or prefill(rep, adm)
        for rid, prompt, n in requests:
            eng.submit(ServeRequest(rid, np.array(prompt, np.int32), n))
        runs.append((trace, {r.rid: r.tokens for r in eng.run()}))
    return dict(last=last.numpy(), tokens=toks.numpy(), trace=runs[0][0],
                engine_tokens=runs[0][1], shed_tokens=runs[1][1])


def _jax(pcg_path, n, params, prompts, lengths):
    """The JAX package's ServingProgram of the plan over n virtual devices
    (n = 0: its single-device lowering of the plan)."""
    from flexflow_tpu.serving.kv_cache import ServingMemorySpec as JMem

    pcg, mapping, _ = jax_load_strategy(str(pcg_path))
    mesh = JaxMesh.for_devices(n, devices=jax.devices()[:n]) if n else None
    prog = JaxProgram(pcg, JMem(SLOTS, SEQ_CAP), mapping=mapping if n else None,
                      machine_mesh=mesh, params={k: jnp.asarray(v) for k, v in params.items()})
    cache, tok, last = prog.prefill(prog.init_cache(), prompts, lengths, np.ones(SLOTS, bool))
    _, _, _, toks = prog.decode_window(cache, np.asarray(tok), lengths, np.ones(SLOTS, bool),
                                       STEPS)
    return dict(last=np.asarray(last), tokens=np.asarray(toks))


def _world(work, n):
    plans = [p for p, w in PLANS.items() if w == n]
    params = {k: v.numpy() for k, v in init_serving_params(
        pcg_from_computation_graph(_builder(SLOTS, 1)[0]), 3, "cpu").items()}
    np.savez(work / "params.npz", **params)
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, 64, (SLOTS, PROMPT)).astype(np.int32)
    lengths = np.array([5, 3, 5, 4], np.int32)
    ref = {"single": _single(params, prompts, lengths)}
    for p in plans:
        pcg, mapping, search = _plan(p)
        save_strategy(str(work / f"{p}.json"), pcg, mapping)
        jmap = search[1].decode.machine_mapping if search else None
        if search:
            ref[f"{p}_search"] = dict(
                port=(t_summary(search[0].decode.pcg), search[0].ms_per_token,
                      search[0].decode_ms, search[0].prefill_ms, search[0].decode.explored),
                jax=(j_summary(search[1].decode.pcg), search[1].ms_per_token,
                     search[1].decode_ms, search[1].prefill_ms, search[1].decode.explored))
            # the JAX program lowers the JAX winner as the JAX search gave it
            jpath = work / f"{p}_jax.json"
            from flexflow_tpu.runtime.strategy import save_strategy as jax_save_strategy

            jax_save_strategy(str(jpath), search[1].decode.pcg, jmap)
            ref[p] = _jax(jpath, n, params, prompts, lengths)
        else:
            ref[p] = _jax(work / f"{p}.json", 0 if p in JAX_MESHLESS else n, params, prompts,
                          lengths)
    cfg = dict(plans=plans, slots=SLOTS, seq_cap=SEQ_CAP, steps=STEPS, prompts=prompts.tolist(),
               lengths=lengths.tolist(), requests=_requests(), shed_requests=_shed_requests(),
               shed_plan="tp2" if n == 2 else None,
               fault_spec=f"seed={_hang_seed(3, 3, 40, 0.05)};sites=hang;rate=0.05")
    (work / "config.json").write_text(json.dumps(cfg))
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "FF_TPU_FAULT_SPEC")}
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(n), str(work)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(n)]
    for proc in procs:
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err
    ref["ranks"] = [json.loads((work / f"rank{r}.json").read_text()) for r in range(n)]
    return ref


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    cache = {}

    def get(n):
        if n not in cache:
            cache[n] = once_per_session(tmp_path_factory, f"serving_ranks{n}",
                                        lambda work: _world(work, n))
        return cache[n]

    return get


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - b) / np.linalg.norm(b)


@pytest.mark.parametrize("n", [2, 4])
def test_serving_search_is_the_jax_packages(worlds, n):
    got = worlds(n)[f"searched{n}_search"]
    (ts, tms, tdec, tpre, texp), (js, jms, jdec, jpre, jexp) = got["port"], got["jax"]
    assert ts == js and texp == jexp
    np.testing.assert_allclose([tms, tdec, tpre], [jms, jdec, jpre], rtol=1e-9)


@pytest.mark.parametrize("plan", PLANS)
def test_prefill_logits_and_decode_tokens_match(worlds, plan):
    world = worlds(PLANS[plan])
    single, jax_ref = world["single"], world[plan]
    np.testing.assert_array_equal(jax_ref["tokens"], single["tokens"])
    for rank in world["ranks"]:
        got = rank[plan]
        assert _rel(got["last"], jax_ref["last"]) < 1e-5
        assert _rel(got["last"], single["last"]) < 1e-5
        np.testing.assert_array_equal(got["tokens"], jax_ref["tokens"])
        assert got["captured"] is False
        # the forced plans' head is column parallel: the greedy token is the
        # argmax across class shards
        assert got["class_cut"] == (plan in ("tp2", "dp2xtp2"))


@pytest.mark.parametrize("plan", PLANS)
def test_each_rank_allocates_the_priced_cache(worlds, plan):
    world = worlds(PLANS[plan])
    for rank in world["ranks"]:
        got = rank[plan]
        assert got["cache_bytes"] == got["priced"]
    whole = 2 * SLOTS * 4 * SEQ_CAP * (2 * 8 * 4)  # layers, heads, k + v of 8 f32
    spec = world["ranks"][0][plan]["specs"]["layer0/k"]
    if plan == "tp2":  # heads cut in 2
        assert spec[0] is None and spec[1] and spec[2:] == [None, None]
        assert got["cache_bytes"] * 2 == whole
    if plan == "dp2xtp2":  # slots and heads cut: a quarter of the cache
        assert spec[0] and spec[1]
        assert got["cache_bytes"] * 4 == whole


@pytest.mark.parametrize("plan", PLANS)
def test_engine_trace_is_equal_on_every_rank_and_the_single_devices(worlds, plan):
    world = worlds(PLANS[plan])
    single = world["single"]
    for rank in world["ranks"]:
        eng = rank[plan]["engine"]
        assert eng["trace"] == single["trace"]
        assert eng["tokens"] == single["engine_tokens"]


def test_watchdog_shed_is_taken_on_every_rank_at_the_same_window(worlds):
    world = worlds(2)
    sheds = [rank["tp2"]["shed"] for rank in world["ranks"]]
    assert sheds[0]["replica_sheds"] == 1
    assert all(s["sheds"] == sheds[0]["sheds"] for s in sheds)
    assert sheds[0]["sheds"][0][0] == 3  # the schedule's window
    assert all(s["tokens"] == world["single"]["shed_tokens"] for s in sheds)


def test_a_fault_posted_on_rank_0_sheds_on_every_rank(worlds):
    """A background fault only rank 0's channel holds: rank 0 broadcasts it
    at the next window boundary (window 2), and every rank sheds the same
    replica there; every request completes with the single-device tokens."""
    world = worlds(2)
    faults = [rank["tp2"]["fault"] for rank in world["ranks"]]
    assert faults[0]["replica_sheds"] == 1 and faults[0]["sheds"] == [[2, 0]]
    assert all(f["sheds"] == faults[0]["sheds"] for f in faults)
    assert all(f["tokens"] == world["single"]["shed_tokens"] for f in faults)
