"""The port's single-device serving (flexflow_tpu_torch.serving) against the
JAX package's (flexflow_tpu.serving with machine_mesh=None), on the CPU at
ServingLMConfig() (vocab 64, embed 32, 4 heads, 2 layers, ffn 64).

Parameters cross from the JAX package's `init_serving_params` as numpy
(interop.serving_params_from_numpy). Prefill logits, next tokens, caches
and decode windows agree within 1e-5 (f32 roundoff of the same arithmetic);
one seeded request trace gives the same tokens, admission order and peak
concurrency through both engines. The shedding tests are the port's own:
the watchdog's budget (1000 ms floor, factor 50) sits far above any real
window, so only the injected hang trips it, and a fault posted on the
FaultChannel sheds with no timing at all.
"""

import jax
import numpy as np
import pytest
import torch

from flexflow_tpu.analysis.memory_accounting import ServingMemorySpec as JMem
from flexflow_tpu.analysis.memory_accounting import kv_cache_piece_bytes as j_piece_bytes
from flexflow_tpu.kernels import ops as jops
from flexflow_tpu.local_execution.training_backing import slot_roles as j_slot_roles
from flexflow_tpu.observability.metrics import nearest_rank_percentile as j_percentile
from flexflow_tpu.observability.metrics import read_run_events as j_read_run_events
from flexflow_tpu.op_attrs import ops as jattrs
from flexflow_tpu.op_attrs.ops.linear_ops import AggregateSpec as JAggr
from flexflow_tpu.pcg.parallel_computation_graph import (
    pcg_from_computation_graph as j_pcg_from_cg,
)
from flexflow_tpu.runtime.fault import FaultSchedule as JFaultSchedule
from flexflow_tpu.serving import ServeRequest as JServeRequest
from flexflow_tpu.serving import ServingEngine as JServingEngine
from flexflow_tpu.serving import ServingLMConfig as JServingLMConfig
from flexflow_tpu.serving import ServingProgram as JServingProgram
from flexflow_tpu.serving import build_serving_lm as j_build_serving_lm
from flexflow_tpu.serving import init_serving_params as j_init_serving_params
from flexflow_tpu.serving.engine import REQUEST_EVENT_FIELDS as J_REQUEST_EVENT_FIELDS
from flexflow_tpu.serving.kv_cache import attention_layers as j_attention_layers
from flexflow_tpu.serving.kv_cache import per_device_cache_bytes as j_cache_bytes
from flexflow_tpu_torch.analysis.memory_accounting import (
    ServingMemorySpec,
    _weight_slot_shape,
    kv_cache_piece_bytes,
)
from flexflow_tpu_torch.interop import serving_params_from_numpy
from flexflow_tpu_torch.kernels import ops as tops
from flexflow_tpu_torch.local_execution.training_backing import slot_roles
from flexflow_tpu_torch.models import ParallelTransformerConfig, build_parallel_transformer
from flexflow_tpu_torch.observability.metrics import nearest_rank_percentile, read_run_events
from flexflow_tpu_torch.op_attrs import ops as tattrs
from flexflow_tpu_torch.pcg import pcg_from_computation_graph
from flexflow_tpu_torch.runtime.fault import FaultSchedule
from flexflow_tpu_torch.serving import (
    ServeRequest,
    ServingEngine,
    ServingLMConfig,
    ServingProgram,
    attention_layers,
    build_serving_lm,
    cache_partition_rules,
    cache_shardings,
    init_serving_params,
    match_partition_rules,
    per_device_cache_bytes,
)
from flexflow_tpu_torch.serving.engine import REQUEST_EVENT_FIELDS

CFG = ServingLMConfig()
JCFG = JServingLMConfig()
SLOTS, SEQ_CAP = 4, 24
MEM = ServingMemorySpec(max_concurrent_seqs=SLOTS, max_seq_len=SEQ_CAP)
JMEM_ = JMem(max_concurrent_seqs=SLOTS, max_seq_len=SEQ_CAP)
TOL = dict(rtol=1e-5, atol=1e-5)
# the flagship's widths (bench.py:37) as a serving LM, on one H100's 64 slots
SERVE_CFG = dict(vocab_size=32000, embed_dim=1024, num_heads=8, num_layers=12, ffn_dim=4096)


@pytest.fixture(scope="module")
def jax_program():
    """The JAX reference program (params seed 3); one instance, so each of
    its programs compiles once for the module."""
    cg, _ = j_build_serving_lm(JCFG, SLOTS, 1)
    return JServingProgram(cg, JMEM_, params_seed=3)


@pytest.fixture(scope="module")
def np_params(jax_program):
    return {k: np.asarray(v) for k, v in jax_program.params.items()}


def _port_program(np_params, slots=SLOTS, mem=MEM):
    cg, _ = build_serving_lm(CFG, slots, 1)
    return ServingProgram(cg, mem, params=serving_params_from_numpy(cg, np_params, "cpu"),
                          device="cpu")


def _np_cache(cache):
    return {name: {part: np.asarray(t) for part, t in kv.items()} for name, kv in cache.items()}


def _assert_caches_close(got, want):
    assert got.keys() == want.keys()
    for name in want:
        for part in ("k", "v"):
            np.testing.assert_allclose(got[name][part], want[name][part], **TOL,
                                       err_msg=f"cache {name}/{part}")


# ---------------------------------------------------------------------------
# Embedding, slot roles, the PCG lift
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("aggr", ["NONE", "SUM", "AVG"])
def test_embedding_forward_and_shapes_match(aggr):
    ja = jattrs.EmbeddingAttrs(50, 12, JAggr[aggr])
    ta = tattrs.EmbeddingAttrs(50, 12, tattrs.AggregateSpec[aggr])
    rs = np.random.RandomState(0)
    idx = rs.randint(0, 50, (3, 7)).astype(np.int32)
    table = rs.randn(50, 12).astype(np.float32)
    (want,) = jops.forward(ja, [idx], [table])
    (got,) = tops.forward(ta, [torch.tensor(idx)], [torch.tensor(table)])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    from flexflow_tpu.op_attrs.datatype import DataType as JDataType
    from flexflow_tpu.op_attrs.parallel_tensor_shape import lift_to_parallel as j_lift
    from flexflow_tpu.op_attrs.tensor_shape import TensorShape as JTensorShape
    from flexflow_tpu_torch.op_attrs.datatype import DataType
    from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import lift_to_parallel
    from flexflow_tpu_torch.op_attrs.tensor_shape import TensorShape

    js, ts = JTensorShape((3, 7), JDataType.INT32), TensorShape((3, 7), DataType.INT32)
    assert ta.output_shape(ts).dims == ja.output_shape(js).dims
    assert ta.weight_shape(ts).dims == ja.weight_shape(js).dims
    for fn in ("parallel_output_shape", "parallel_weight_shape"):
        got_p, want_p = getattr(ta, fn)(lift_to_parallel(ts)), getattr(ja, fn)(j_lift(js))
        assert got_p.sizes() == tuple(d.size for d in want_p.dims.shard_dims)
        assert got_p.shard_degrees() == tuple(d.degree for d in want_p.dims.shard_dims)
        assert (got_p.sum_degree, got_p.discard_copy_degree) == (
            want_p.dims.sum_degree, want_p.dims.discard_copy_degree)
    assert [r.value for r in slot_roles(ta, 2)] == [r.value for r in j_slot_roles(ja, 2)]
    assert [r.value for r in slot_roles(ta, 3)] == [r.value for r in j_slot_roles(ja, 3)]


def test_pcg_lift_matches_node_for_node():
    jpcg = j_pcg_from_cg(j_build_serving_lm(JCFG, SLOTS, 5)[0])
    tpcg = pcg_from_computation_graph(build_serving_lm(CFG, SLOTS, 5)[0])
    jorder, torder = jpcg.topological_ordering(), tpcg.topological_ordering()
    assert [n.idx for n in torder] == [n.idx for n in jorder]
    for jn, tn in zip(jorder, torder):
        assert type(tpcg.op_attrs(tn)).__name__ == type(jpcg.op_attrs(jn)).__name__
        (jo,), (to,) = jpcg.outputs_of(jn), tpcg.outputs_of(tn)
        assert tpcg.tensor_shape(to).sizes() == tuple(
            d.size for d in jpcg.tensor_shape(jo).dims.shard_dims)
        assert [v.node.idx for v in tpcg.inputs_of(tn)] == [v.node.idx for v in jpcg.inputs_of(jn)]


# ---------------------------------------------------------------------------
# The cache layout and its accounting
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg, slots, seqs", [
    (dict(), 8, 16),
    (SERVE_CFG, 64, 1024),
])
def test_cache_layout_and_bytes_match(cfg, slots, seqs):
    jpcg = j_pcg_from_cg(j_build_serving_lm(JServingLMConfig(**cfg), slots, 1)[0])
    tpcg = pcg_from_computation_graph(build_serving_lm(ServingLMConfig(**cfg), slots, 1)[0])
    spec, jspec = ServingMemorySpec(slots, seqs), JMem(slots, seqs)
    jl, tl = j_attention_layers(jpcg), attention_layers(tpcg)
    assert [(l.name, l.node.idx) for l in tl] == [(l.name, l.node.idx) for l in jl]
    assert per_device_cache_bytes(tpcg, tl, spec) == j_cache_bytes(jpcg, jl, jspec)
    for t, j in zip(tl, jl):
        tins, jins = tpcg.inputs_of(t.node), jpcg.inputs_of(j.node)
        assert kv_cache_piece_bytes(
            t.attrs, tpcg.tensor_shape(tins[0]),
            _weight_slot_shape(t.attrs, [tpcg.tensor_shape(v) for v in tins]), spec,
        ) == j_piece_bytes(j.attrs, jpcg.tensor_shape(jins[0]), jpcg.tensor_shape(jins[3]), jspec)
    a = tl[0].attrs
    assert spec.per_seq_cache_bytes(a.num_heads, a.k_proj_size, a.v_proj_size, len(tl)) == \
        jspec.per_seq_cache_bytes(a.num_heads, a.k_proj_size, a.v_proj_size, len(tl))
    if cfg:
        # the flagship serve config: 2 (K+V) x 64 x 1024 x 8 x 128 x 4 B x 12 layers
        assert per_device_cache_bytes(tpcg, tl, spec) == 6_442_450_944


def test_partition_rules_and_single_device_allocation():
    pcg = pcg_from_computation_graph(build_serving_lm(CFG, SLOTS, 1)[0])
    layers = attention_layers(pcg)
    rules = cache_partition_rules(layers)
    names = {"layer0/k": None, "layer1/v": None, "aux/step": None}
    specs = match_partition_rules(rules, names)
    assert specs == {"layer0/k": (None, None, None, None),
                     "layer1/v": (None, None, None, None), "aux/step": ()}
    with pytest.raises(ValueError, match="partition rule not found for cache leaf: aux/step"):
        match_partition_rules(rules[:-1], names)
    assert cache_shardings(layers, None) == {}
    # over a mesh: each leaf's spec from the rules, here all axes unbound
    assert cache_shardings(layers, object()) == {
        f"{layer.name}/{kv}": (None, None, None, None) for layer in layers for kv in "kv"}
    prog = ServingProgram(pcg, MEM, device="cpu")
    cache = prog.init_cache()
    leaves = [t for kv in cache.values() for t in kv.values()]
    assert all(t.shape == (SLOTS, 4, SEQ_CAP, 8) and t.dtype == torch.float32
               and not t.any() for t in leaves)
    assert sum(t.numel() * t.element_size() for t in leaves) == \
        per_device_cache_bytes(pcg, layers, MEM)


def test_ring_attention_refused():
    cfg = ParallelTransformerConfig(batch_size=2, sequence_length=64, num_features=64,
                                    num_heads=2, num_layers=1, vocab_size=16, causal=True)
    pcg, _ = build_parallel_transformer(cfg)
    with pytest.raises(NotImplementedError, match="RingAttention"):
        attention_layers(pcg)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def test_weight_ordinals_and_shapes_match(np_params):
    tpcg = pcg_from_computation_graph(build_serving_lm(CFG, SLOTS, 1)[0])
    jpcg = j_pcg_from_cg(j_build_serving_lm(JCFG, SLOTS, 1)[0])
    want = {k: tuple(v.shape) for k, v in j_init_serving_params(jpcg, jax.random.PRNGKey(0)).items()}
    got = init_serving_params(tpcg, 0, "cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == want
    assert {k: v.shape for k, v in np_params.items()} == want
    assert all(v.dtype == torch.float32 for v in got.values())
    with pytest.raises(ValueError, match="missing \\['w0'\\]"):
        serving_params_from_numpy(tpcg, {k: v for k, v in np_params.items() if k != "w0"}, "cpu")
    with pytest.raises(ValueError, match="parameter w1: shape"):
        serving_params_from_numpy(tpcg, {**np_params, "w1": np_params["w1"].T}, "cpu")


# ---------------------------------------------------------------------------
# Prefill and the decode window against the JAX program
# ---------------------------------------------------------------------------


def _prompts(seed, n, length):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, (n, length)).astype(np.int32)


def test_prefill_matches_jax(jax_program, np_params):
    """A full admission with ragged lengths, then a second admitting two
    slots over the first's cache (the other two keep their bits)."""
    prompts = _prompts(0, SLOTS, 6)
    lengths = np.array([6, 4, 5, 6], np.int32)
    fresh = np.ones(SLOTS, bool)
    prog = _port_program(np_params)
    cache, tok, last = prog.prefill(prog.init_cache(), prompts, lengths, fresh)
    jcache, jtok, jlast = jax_program.prefill(jax_program.init_cache(), prompts, lengths, fresh)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), **TOL)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    _assert_caches_close(_np_cache(cache), _np_cache(jcache))

    before = _np_cache(cache)
    prompts2 = _prompts(1, SLOTS, 3)
    lengths2 = np.array([6, 3, 5, 2], np.int32)
    fresh2 = np.array([False, True, False, True])
    cache, tok, last = prog.prefill(cache, prompts2, lengths2, fresh2)
    jcache, jtok, jlast = jax_program.prefill(jcache, prompts2, lengths2, fresh2)
    np.testing.assert_allclose(last.numpy()[fresh2], np.asarray(jlast)[fresh2], **TOL)
    np.testing.assert_array_equal(tok.numpy()[fresh2], np.asarray(jtok)[fresh2])
    after = _np_cache(cache)
    _assert_caches_close(after, _np_cache(jcache))
    for name in after:
        for part in ("k", "v"):
            np.testing.assert_array_equal(after[name][part][~fresh2], before[name][part][~fresh2])


def test_decode_window_matches_jax(jax_program, np_params):
    prompts = _prompts(2, SLOTS, 6)
    lengths = np.full(SLOTS, 6, np.int32)
    active = np.array([True, True, False, True])
    prog = _port_program(np_params)
    cache, tok, _ = prog.prefill(prog.init_cache(), prompts, lengths, np.ones(SLOTS, bool))
    cache, tok, lens, toks = prog.decode_window(cache, tok.numpy(), lengths, active, 5)
    jcache, jtok, _ = jax_program.prefill(jax_program.init_cache(), prompts, lengths,
                                          np.ones(SLOTS, bool))
    jcache, jtok, jlens, jtoks = jax_program.decode_window(jcache, np.asarray(jtok), lengths,
                                                           active, 5)
    np.testing.assert_array_equal(toks.numpy()[active], np.asarray(jtoks)[active])
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))
    _assert_caches_close(_np_cache(cache), _np_cache(jcache))


def test_fused_vs_per_step_bitwise(np_params):
    """One 8-step window == 8 one-step windows: identical tokens and a
    bit-identical cache (port against port)."""
    prompts = _prompts(0, SLOTS, 6)
    lengths = np.full(SLOTS, 6, np.int32)
    fresh = active = np.ones(SLOTS, bool)
    prog = _port_program(np_params)
    cache, tok, _ = prog.prefill(prog.init_cache(), prompts, lengths, fresh)
    cache, _, len_f, toks_fused = prog.decode_window(cache, tok, lengths, active, 8)

    prog2 = _port_program(np_params)
    c2, t2, _ = prog2.prefill(prog2.init_cache(), prompts, lengths, fresh)
    l2, steps = lengths, []
    for _ in range(8):
        c2, t2, l2, s = prog2.decode_window(c2, t2, l2, active, 1)
        steps.append(s[:, 0])
    assert torch.equal(toks_fused, torch.stack(steps, dim=1))
    assert torch.equal(len_f, l2)
    for name, kv in cache.items():
        for part in ("k", "v"):
            assert torch.equal(kv[part], c2[name][part]), f"cache {name}/{part} diverged"


def test_prefill_matches_teacher_forced_decode(np_params):
    """Prefilling p tokens == prefilling 1 and decode-feeding the rest
    (teacher-forced): the sampled next token agrees."""
    prompts = _prompts(1, SLOTS, 6)
    fresh = active = np.ones(SLOTS, bool)
    prog = _port_program(np_params)
    _, tok_full, last_full = prog.prefill(prog.init_cache(), prompts,
                                          np.full(SLOTS, 6, np.int32), fresh)
    prog2 = _port_program(np_params)
    one = np.ones(SLOTS, np.int32)
    cache, tok, _ = prog2.prefill(prog2.init_cache(), prompts[:, :1], one, fresh)
    lens = one
    for j in range(1, 6):
        cache, tok, lens, _ = prog2.decode_window(cache, prompts[:, j], lens, active, 1)
    assert torch.equal(tok_full, tok)


# ---------------------------------------------------------------------------
# The engine against the JAX engine
# ---------------------------------------------------------------------------


def _requests(make, seed=7, n=10, slo=None):
    rng = np.random.default_rng(seed)
    return [
        make(rid=f"r{i}", prompt=rng.integers(0, CFG.vocab_size, int(rng.choice([4, 6])))
             .astype(np.int32), max_new_tokens=int(rng.integers(2, 12)), slo_ms_per_token=slo)
        for i in range(n)
    ]


def _trace(engine, requests):
    """(admission schedule, tokens per rid, max_observed_concurrent)."""
    schedule = []
    orig = engine._prefill

    def spy(replica, admitted):
        schedule.append((engine.windows, tuple(replica.slots[i].request.rid for i in admitted)))
        return orig(replica, admitted)

    engine._prefill = spy
    for r in requests:
        engine.submit(r)
    recs = engine.run()
    return schedule, {r.rid: list(r.tokens) for r in recs}, engine.max_observed_concurrent


@pytest.mark.parametrize("mode", ["continuous", "static"])
def test_engine_trace_matches_jax(jax_program, np_params, mode):
    want = _trace(JServingEngine(jax_program, mode=mode, window_steps=3),
                  _requests(JServeRequest))
    got = _trace(ServingEngine(_port_program(np_params), mode=mode, window_steps=3),
                 _requests(ServeRequest))
    assert got == want
    assert len(got[1]) == 10
    if mode == "continuous":
        assert any(w > 1 for w, _ in got[0])  # slots were refilled mid-run
    else:
        assert len(got[0]) == 3  # 10 requests / 4 slots, each batch drained


def test_events_read_by_jax_reader_and_slo_counter(np_params, tmp_path):
    assert REQUEST_EVENT_FIELDS == J_REQUEST_EVENT_FIELDS
    eng = ServingEngine(_port_program(np_params), window_steps=3, metrics_dir=str(tmp_path))
    for r in _requests(ServeRequest, seed=3, n=6, slo=1e-6):  # an impossible SLO
        eng.submit(r)
    assert len(eng.run()) == 6
    assert eng.slo_violations == 6
    events = j_read_run_events(str(tmp_path), "serve_request")
    assert events == read_run_events(str(tmp_path), "serve_request")
    assert len(events) == 6
    for e in events:
        assert set(e) == {"schema", "event", *REQUEST_EVENT_FIELDS}
        assert e["slo_violated"] is True and e["tokens"] >= 1 and e["schema"] == 1
    s = eng.summary()
    assert (s["slo_violations"], s["completed"]) == (6, 6)
    assert s["p50_ms_per_token"] <= s["p99_ms_per_token"]


def test_admission_cap_and_oversized_request(np_params):
    eng = ServingEngine(_port_program(np_params), window_steps=3, max_concurrent=2)
    for r in _requests(ServeRequest, seed=5, n=6):
        eng.submit(r)
    eng.run()
    assert eng.max_observed_concurrent == 2
    assert len(eng.completed) == 6
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.submit(ServeRequest(rid="big", prompt=np.zeros(20, np.int32), max_new_tokens=20))


@pytest.mark.parametrize("samples", [[], [3.0], [1.0, 2.0], list(range(1, 101))])
@pytest.mark.parametrize("q", [0, 50, 99, 100])
def test_nearest_rank_percentile_matches(samples, q):
    assert nearest_rank_percentile(samples, q) == j_percentile(samples, q)


# ---------------------------------------------------------------------------
# Fault schedules and replica shedding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    "seed=7;sites=hang;rate=0.05",
    "seed=123;sites=hang,h2d;rate=0.2",
    "sites=ckpt_write,kill;seed=0;rate=0.5",
    "seed=99;sites=slow,nonfinite;rate=1.0",
])
def test_fault_schedule_matches_jax(spec):
    got, want = FaultSchedule.parse(spec), JFaultSchedule.parse(spec)
    assert got.canonical_spec() == want.canonical_spec()
    for site in ("ckpt_write", "h2d", "nonfinite", "hang", "kill", "slow"):
        assert got.fire_steps(site, 1, 300) == want.fire_steps(site, 1, 300)
    fired = got.fire_steps("hang", 1, 300)
    if fired:
        assert got.fire_once("hang", fired[0]) and not got.fire_once("hang", fired[0])


@pytest.mark.parametrize("spec", ["seed=1;sites=disk;rate=0.1", "seed=1;rate=2", "seed=1;x=2"])
def test_bad_fault_spec_refused_like_jax(spec):
    with pytest.raises(ValueError):
        JFaultSchedule.parse(spec)
    with pytest.raises(ValueError):
        FaultSchedule.parse(spec)


def _two_replicas(np_params):
    mem = ServingMemorySpec(max_concurrent_seqs=2, max_seq_len=SEQ_CAP)
    return [_port_program(np_params, slots=2, mem=mem) for _ in range(2)]


def _submit_eight(eng):
    rng = np.random.default_rng(0)
    for i in range(8):
        eng.submit(ServeRequest(rid=f"r{i}", prompt=rng.integers(0, 64, 4).astype(np.int32),
                                max_new_tokens=6))


def _single_hang_seed(lo, hi, horizon, rate):
    for seed in range(100000):
        fired = FaultSchedule(seed=seed, sites=frozenset({"hang"}), rate=rate).fire_steps(
            "hang", 1, horizon)
        if len(fired) == 1 and lo <= fired[0] <= hi:
            return seed
    raise AssertionError("no single-firing hang seed found")


def test_watchdog_sheds_hung_replica(np_params, monkeypatch, tmp_path):
    """FF_TPU_FAULT_SPEC site "hang" inside an armed decode window: the
    watchdog fires, the replica sheds, its requests resubmit to the other
    replica, and every request completes. The budget (>= 1000 ms, 50x the
    window estimate) leaves only the injected hang able to trip it."""
    seed = _single_hang_seed(3, 6, 40, 0.05)
    monkeypatch.setenv("FF_TPU_FAULT_SPEC", f"seed={seed};sites=hang;rate=0.05")
    eng = ServingEngine(_two_replicas(np_params), window_steps=2, watchdog_factor=50.0,
                        watchdog_min_budget_ms=1000.0, metrics_dir=str(tmp_path))
    _submit_eight(eng)
    try:
        recs = eng.run()
    finally:
        eng.close()
    assert eng.replica_sheds == 1
    assert eng.schedule.fired_log == [("hang", eng.schedule.fire_steps("hang", 1, 40)[0])]
    assert sorted(r.rid for r in recs) == [f"r{i}" for i in range(8)]
    assert all(len(r.tokens) == 6 for r in recs)
    assert any(r.resubmitted for r in recs)
    (shed,) = read_run_events(str(tmp_path), "replica_shed")
    assert "WindowHangError" in shed["reason"] and shed["requeued"]
    (hang,) = read_run_events(str(tmp_path), "serve_hang")
    assert hang["budget_ms"] >= 1000.0 and hang["device_kind"] == "cpu"
    assert all(r.replica != shed["replica"] for r in recs if r.resubmitted)


def test_background_fault_sheds_replica(np_params, tmp_path):
    """A fault posted on the FaultChannel sheds the first replica to reach
    the next window boundary, with no timing involved."""
    eng = ServingEngine(_two_replicas(np_params), window_steps=2, metrics_dir=str(tmp_path))
    _submit_eight(eng)
    eng.run(max_windows=2)
    eng.channel.post("h2d", OSError("injected producer fault"))
    eng.run()
    eng.close()
    assert eng.replica_sheds == 1 and eng.channel.pending() == 0
    assert sorted(r.rid for r in eng.completed) == [f"r{i}" for i in range(8)]
    assert all(len(r.tokens) == 6 for r in eng.completed)
    (shed,) = read_run_events(str(tmp_path), "replica_shed")
    assert shed["replica"] == 0 and shed["reason"].startswith("BackgroundFault")
    assert len(shed["requeued"]) == 2
    late = [r for r in eng.completed if r.resubmitted]
    assert sorted(r.rid for r in late) == sorted(shed["requeued"])
    assert all(r.replica == 1 for r in late)
