"""The port's utilities and command-line tools against the JAX package's, on
the CPU: `flexflow_tpu_torch.utils.bidict` and `.cli` (tests/test_cli.py's
cases in both), and `flexflow_tpu_torch.tools` against `tools/cost_db.py`,
`tools/ffreport.py` and `bin/*.py`. Each tool's main is called in-process
with its output captured; the JAX bin tools read sys.argv, which the calls
set for the duration."""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import sys

import numpy as np
import pytest

from flexflow_tpu.compiler.cost_store import CostStore as JCostStore
from flexflow_tpu.compiler.movement_store import MovementCostStore as JMovementStore
from flexflow_tpu.op_attrs import ops as j_ops
from flexflow_tpu.op_attrs.parallel_tensor_shape import (
    ParallelTensorDims as JDims,
    ParallelTensorShape as JPShape,
    ShardParallelDim as JShard,
)
from flexflow_tpu.op_attrs.tensor_shape import TensorShape as JShape
from flexflow_tpu.pcg import machine_view as jmv
from flexflow_tpu.utils import bidict as jbidict
from flexflow_tpu.utils import cli as jcli
from flexflow_tpu_torch.compiler.cost_store import CostStore as TCostStore
from flexflow_tpu_torch.compiler.movement_store import MovementCostStore as TMovementStore
from flexflow_tpu_torch.op_attrs import ops as t_ops
from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import (
    ParallelTensorDims as TDims,
    ParallelTensorShape as TPShape,
    ShardParallelDim as TShard,
)
from flexflow_tpu_torch.op_attrs.tensor_shape import TensorShape as TShape
from flexflow_tpu_torch.pcg import machine_view as tmv
from flexflow_tpu_torch.tools import (
    arg_parser as t_arg_parser,
    cost_db as t_cost_db,
    export_model_arch as t_export,
    ffreport as t_ffreport,
    protobuf_to_json as t_pb2json,
    substitution_to_dot as t_subst_dot,
)
from flexflow_tpu_torch.utils import bidict as tbidict
from flexflow_tpu_torch.utils import cli as tcli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _CurrentStdout:
    """Writes to whatever sys.stdout is when written to: the JAX ffreport
    binds sys.stdout as a default argument when it is imported."""

    def __init__(self, fallback):
        self.fallback = fallback

    def _target(self):
        return self.fallback if sys.stdout is self else sys.stdout

    def write(self, s):
        return self._target().write(s)

    def flush(self):
        self._target().flush()


def _load(relpath: str, name: str):
    """A JAX-side script as a module (tools/ on the path for audit_env)."""
    tools = os.path.join(REPO, "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, relpath))
    mod = importlib.util.module_from_spec(spec)
    saved = sys.stdout
    sys.stdout = _CurrentStdout(saved)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.stdout = saved
    return mod


@pytest.fixture(scope="module")
def jtools():
    return {
        "cost_db": _load("tools/cost_db.py", "jax_cost_db_tool"),
        "ffreport": _load("tools/ffreport.py", "jax_ffreport_tool"),
        "export_model_arch": _load("bin/export_model_arch.py", "jax_export_model_arch"),
        "substitution_to_dot": _load("bin/substitution_to_dot.py", "jax_substitution_to_dot"),
        "protobuf_to_json": _load("bin/protobuf_to_json.py", "jax_protobuf_to_json"),
        "arg_parser": _load("bin/arg_parser.py", "jax_arg_parser"),
    }


def _call(main, argv=None, sys_argv=None):
    """(exit code, stdout, stderr) of main(argv), or of main() with
    sys.argv set to sys_argv (the JAX bin tools' interface)."""
    out, err = io.StringIO(), io.StringIO()
    saved = sys.argv
    try:
        if sys_argv is not None:
            sys.argv = ["prog", *sys_argv]
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                rc = main(argv) if sys_argv is None else main()
            except SystemExit as e:
                rc = e.code if isinstance(e.code, int) else (0 if e.code is None else 1)
    finally:
        sys.argv = saved
    return (0 if rc is None else rc), out.getvalue(), err.getvalue()


# --- utils: bidict and cli ----------------------------------------------------


@pytest.mark.parametrize("pkg", [jbidict, tbidict], ids=["jax", "port"])
def test_bidict(pkg):
    b = pkg.bidict({1: "a", 2: "b"})
    assert b.at_l(1) == "a" and b.at_r("b") == 2
    assert 1 in b and b.contains_r("a") and len(b) == 2
    b.put(1, "a")  # the same pair again is a no-op
    with pytest.raises(ValueError):
        b.put(1, "c")
    with pytest.raises(ValueError):
        b.put(3, "a")
    inv = b.inverse()
    assert inv.at_l("a") == 1 and inv.backward() == {1: "a", 2: "b"}
    assert sorted(b) == [(1, "a"), (2, "b")]
    assert b == pkg.bidict({2: "b", 1: "a"}) and b != inv
    assert repr(b) == "bidict({1: 'a', 2: 'b'})"


def test_bidict_matches_the_jax_copy():
    items = {i: f"v{i}" for i in range(10)}
    j, t = jbidict.bidict(items), tbidict.bidict(items)
    assert j.forward() == t.forward() and j.backward() == t.backward()
    assert repr(j) == repr(t) and list(j) == list(t)


def _spec(cli):
    spec = cli.CLISpec(program="tool", description="a tool")
    keys = (
        spec.add_flag("budget", short_name="b", type=int, default=10, help="search budget"),
        spec.add_flag("verbose", type=bool, help="chatty"),
        spec.add_flag("mode", type=str, default="fast", choices=["fast", "slow"]),
        spec.add_positional("model", choices=["mlp", "bert"]),
    )
    return spec, keys


CLI_OK = [["mlp"], ["--budget", "5", "--verbose", "bert"], ["-b", "7", "mlp"],
          ["--budget=3", "mlp"], ["--mode", "slow", "mlp"]]
CLI_BAD = [["--nope", "mlp"], ["--mode", "medium", "mlp"], [], ["mlp", "extra"], ["--budget"]]


@pytest.mark.parametrize("argv", CLI_OK, ids=lambda a: " ".join(a) or "none")
def test_cli_parses_as_the_jax_copy(argv):
    (jspec, jkeys), (tspec, tkeys) = _spec(jcli), _spec(tcli)
    jr, tr = jcli.cli_parse(jspec, argv), tcli.cli_parse(tspec, argv)
    got = [tr.get(k) for k in tkeys]
    assert got == [jr.get(k) for k in jkeys]
    assert tr.flag_values == jr.flag_values and tr.positional_values == jr.positional_values


def test_cli_defaults_and_forms():
    spec, (kb, kv, km, kmod) = _spec(tcli)
    r = tcli.cli_parse(spec, ["mlp"])
    assert (r.get(kb), r.get(kv), r.get(km), r.get(kmod)) == (10, False, "fast", "mlp")
    r = tcli.cli_parse(spec, ["--budget", "5", "--verbose", "bert"])
    assert (r.get(kb), r.get(kv)) == (5, True)
    assert tcli.cli_parse(spec, ["-b", "7", "mlp"]).get(kb) == 7
    assert tcli.cli_parse(spec, ["--budget=3", "mlp"])["budget"] == 3


@pytest.mark.parametrize("argv", CLI_BAD, ids=lambda a: " ".join(a) or "none")
def test_cli_errors_as_the_jax_copy(argv):
    jspec, _ = _spec(jcli)
    tspec, _ = _spec(tcli)
    with pytest.raises(jcli.CLIParseError) as je:
        jcli.cli_parse(jspec, argv)
    with pytest.raises(tcli.CLIParseError) as te:
        tcli.cli_parse(tspec, argv)
    assert str(te.value) == str(je.value)


def test_cli_negative_number_positional_and_help():
    spec = tcli.CLISpec()
    k = spec.add_positional("n", type=int)
    assert tcli.cli_parse(spec, ["-5"]).get(k) == -5
    msg = tcli.cli_get_help_message(_spec(tcli)[0])
    assert "--budget" in msg and "model" in msg and "usage:" in msg
    assert msg == jcli.cli_get_help_message(_spec(jcli)[0])


# --- cost_db --------------------------------------------------------------------


def _pts(pkg, sizes, degrees):
    dims, shard, shape, ops = ((TDims, TShard, TPShape, t_ops) if pkg == "t"
                               else (JDims, JShard, JPShape, j_ops))
    return shape(dims(tuple(shard(s, d) for s, d in zip(sizes, degrees)), 1, 1),
                 ops.LinearAttrs(1).dtype)


def _view(mv):
    return mv.MachineView(mv.MachineSpaceCoordinate(0, 0),
                          (mv.MachineViewDimension(1, mv.ProjectionType.INTRA_NODE),))


def _jax_store(d) -> str:
    """A cost database the JAX package's CostStore wrote: op entries of two
    device kinds, one analytic pair."""
    lin = j_ops.LinearAttrs(out_channels=8, use_bias=False)
    ins, ws = (JShape((4, 16)),), (JShape((16, 8)),)
    os.makedirs(d, exist_ok=True)
    s = JCostStore(d, device_kind="cpu:cpu")
    s.put_op(lin, ins, ws, 1.5, 64)
    s.note_analytic(lin, ins, ws, 0.5)
    s.put_op(j_ops.LinearAttrs(out_channels=16, use_bias=False), ins, (JShape((16, 16)),), 2.5)
    s.save()
    t = JCostStore(d, device_kind="tpu:TPU v4")
    t.put_op(lin, ins, None, 0.01)
    t.save()
    return s.path


def _port_store(d) -> str:
    """A cost database the port's CostStore wrote, with a movement edge over
    NVLink."""
    lin = t_ops.LinearAttrs(out_channels=8, use_bias=False)
    os.makedirs(d, exist_ok=True)
    s = TCostStore(d, device_kind="cuda:NVIDIA H100 80GB HBM3")
    s.put_op(lin, (TShape((4, 16)),), (TShape((16, 8)),), 0.02, 64)
    s.put_edge(t_ops.CombineAttrs(0, 4), [_pts("t", [16, 32], [4, 1])], _view(tmv), 0.25)
    s.save()
    return s.path


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    base = tmp_path_factory.mktemp("stores")
    out = {"jax": _jax_store(str(base / "jax")), "port": _port_store(str(base / "port"))}
    # movement tables of either package's link classes
    for pkg, store_cls, link in (("j", JMovementStore, "ici"), ("t", TMovementStore, "nvlink")):
        path = str(base / f"movement_{pkg}.json")
        ms = store_cls(path)
        ops = t_ops if pkg == "t" else j_ops
        ms.put_edge(ops.CombineAttrs(0, 4), [_pts(pkg, [16, 32], [4, 1])],
               _view(tmv if pkg == "t" else jmv), 0.25, link_class=link)
        ms.save()
        out[f"movement_{pkg}"] = path
    return out


@pytest.mark.parametrize("argv", [["stats", "{path}"], ["stats", "{path}", "--json"],
                                  ["stats", "{dir}", "--json"], ["verify", "{path}"]],
                         ids=["stats", "stats-json", "stats-dir", "verify"])
def test_cost_db_reads_a_jax_store_as_the_jax_tool(jtools, stores, argv):
    path = stores["jax"]
    argv = [a.format(path=path, dir=os.path.dirname(path)) for a in argv]
    want = _call(jtools["cost_db"].main, argv)
    got = _call(t_cost_db.main, argv)
    assert got == want and got[0] == 0


@pytest.mark.parametrize("flags", [["--device-kind", "cpu:cpu"], ["--family", "train"],
                                   ["--older-than-schema", "2"]],
                         ids=["device-kind", "family", "schema"])
def test_cost_db_prunes_as_the_jax_tool(jtools, tmp_path, flags):
    outs = []
    for main, sub in ((jtools["cost_db"].main, "j"), (t_cost_db.main, "t")):
        path = _jax_store(str(tmp_path / sub))
        rc, out, err = _call(main, ["prune", path, *flags])
        with open(path) as f:
            outs.append((rc, out.replace(str(tmp_path / sub), "<d>"), err, json.load(f)))
    assert outs[0] == outs[1] and outs[1][0] == 0


def test_cost_db_verify_flags_a_bad_value_as_the_jax_tool(jtools, tmp_path):
    path = _jax_store(str(tmp_path))
    with open(path) as f:
        data = json.load(f)
    k = next(iter(data["entries"]))
    data["entries"][k] = dict(data["entries"][k], ms=float("nan"))
    with open(path, "w") as f:
        json.dump(data, f)
    want = _call(jtools["cost_db"].main, ["verify", path])
    got = _call(t_cost_db.main, ["verify", path])
    assert got == want and got[0] == 1 and "finite" in got[2]


def test_cost_db_verifies_a_port_store_clean(stores):
    rc, out, err = _call(t_cost_db.main, ["verify", stores["port"]])
    assert rc == 0 and "2 entries verified (cost_db, schema 1)" in out, err
    rc, out, _ = _call(t_cost_db.main, ["stats", stores["port"], "--json"])
    doc = json.loads(out)
    assert rc == 0 and doc["by_device_kind"] == {"cuda:NVIDIA H100 80GB HBM3": 2}
    assert doc["by_link_class"] == {"nvlink": 1}


def test_cost_db_link_classes_are_the_cards(jtools, stores):
    """The port's movement tables name NVLink and InfiniBand where the JAX
    package's name ici and dcn: each tool verifies its own package's
    schema-3 table clean and refuses the other's link classes."""
    assert _call(t_cost_db.main, ["verify", stores["movement_t"]])[0] == 0
    assert _call(jtools["cost_db"].main, ["verify", stores["movement_j"]])[0] == 0
    rc, _, err = _call(jtools["cost_db"].main, ["verify", stores["movement_t"]])
    assert rc == 1 and "no known link class" in err
    rc, _, err = _call(t_cost_db.main, ["verify", stores["movement_j"]])
    assert rc == 1 and "no known link class" in err
    assert _call(t_cost_db.main, ["prune", stores["movement_t"], "--link-class", "ici"])[0] == 2


def test_cost_db_imports_no_torch():
    import subprocess

    code = ("import sys; import flexflow_tpu_torch.tools.cost_db; "
            "sys.exit(1 if 'torch' in sys.modules else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr


# --- ffreport ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def metrics_dir(tmp_path_factory):
    """A metrics directory the port's fit wrote: the spec MLP, 4 steps."""
    from flexflow_tpu_torch.core import Activation, FFConfig, FFModel, SGDOptimizer

    d = str(tmp_path_factory.mktemp("metrics"))
    m = FFModel(FFConfig(batch_size=8, print_freq=0, seed=0, metrics_dir=d), device="cpu")
    x = m.create_tensor([8, 32], name="x")
    m.dense(m.dense(x, 16, activation=Activation.RELU, name="fc1"), 4, name="out")
    m.compile(SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy", metrics=["accuracy"])
    rs = np.random.RandomState(0)
    m.fit(rs.randn(32, 32).astype(np.float32), rs.randint(0, 4, 32), epochs=1,
          shuffle=False, verbose=False)
    return d


@pytest.mark.parametrize("json_out", [True, False], ids=["json", "text"])
def test_ffreport_reports_a_port_run_as_the_jax_tool(jtools, metrics_dir, json_out):
    argv = (["--json"] if json_out else []) + [metrics_dir]
    got = _call(t_ffreport.main, argv)
    assert got == _call(jtools["ffreport"].main, argv) and got[0] == 0
    assert "health" in got[1]
    if json_out:
        sections = {s["section"]: s for s in map(json.loads, got[1].splitlines())}
        assert sections["health"]["steps"] == 4
        assert {"health", "throughput", "timeline", "drift", "plan"} <= set(sections)


def test_ffreport_follow_prints_every_step(jtools, metrics_dir):
    argv = ["--follow", "--follow-polls", "1", "--poll-interval", "0", metrics_dir]
    got = _call(t_ffreport.main, argv)
    assert got == _call(jtools["ffreport"].main, argv)
    assert sum(line.startswith("step ") for line in got[1].splitlines()) == 4


def test_ffreport_exit_contract(jtools, tmp_path):
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    for argv in ([empty], ["--json", empty], [str(tmp_path / "missing")]):
        got = _call(t_ffreport.main, argv)
        assert got[0] == 1 and got == _call(jtools["ffreport"].main, argv)
    torn = str(tmp_path / "torn")
    os.makedirs(torn)
    with open(os.path.join(torn, "events.jsonl"), "w") as f:
        f.write(json.dumps({"step": 0, "loss": 1.0, "wallclock_ms": 2.0}) + "\n")
    with open(os.path.join(torn, "provenance.json"), "w") as f:
        f.write("{torn")
    assert _call(t_ffreport.main, [torn])[0] == 1


# --- the bin tools ------------------------------------------------------------------


@pytest.mark.parametrize("model", t_export.MODEL_OPTIONS)
@pytest.mark.parametrize("flags", [[], ["--sp-decomposition"], ["--dot"], ["--preprocessed-dot"]],
                         ids=["json", "sp", "dot", "preprocessed-dot"])
def test_export_model_arch_as_the_jax_tool(jtools, model, flags):
    got = _call(t_export.main, [model, *flags])
    assert got == _call(jtools["export_model_arch"].main, sys_argv=[model, *flags])
    assert got[0] == 0 and got[1]


def test_export_model_arch_rejects_an_unknown_model(jtools):
    got = _call(t_export.main, ["nonexistent_model"])
    want = _call(jtools["export_model_arch"].main, sys_argv=["nonexistent_model"])
    assert got[0] == want[0] == 2 and not got[1] and not want[1]
    for _, _, err in (got, want):
        assert "invalid choice: 'nonexistent_model'" in err


def _varint(v):
    if v < 0:
        v += 1 << 64
    out = b""
    while True:
        b7 = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b7 | 0x80])
        else:
            return out + bytes([b7])


def _field(n, wt, payload):
    tag = _varint((n << 3) | wt)
    if wt == 0:
        return tag + _varint(payload)
    return tag + _varint(len(payload)) + payload


def _rule_collection() -> bytes:
    """tests/test_bin_tools.py's collection: Linear(graph input, PM_ACTI=
    NONE) -> the same, the output mapped; and a second rule, an elementwise
    add partitioned along dim 1."""
    tensor = _field(1, 0, -1) + _field(2, 0, 0)
    para = _field(1, 0, 9) + _field(2, 0, 0)
    lin = _field(1, 0, 5) + _field(2, 2, tensor) + _field(3, 2, para)
    mo = _field(1, 0, 0) + _field(2, 0, 0) + _field(3, 0, 0) + _field(4, 0, 0)
    rule = _field(1, 2, lin) + _field(2, 2, lin) + _field(3, 2, mo)
    return _field(1, 2, rule) + _field(1, 2, rule)


@pytest.fixture(scope="module")
def rules_json(jtools, tmp_path_factory):
    d = tmp_path_factory.mktemp("rules")
    pb = d / "rules.pb"
    pb.write_bytes(_rule_collection())
    outs = {}
    for name, main, kw in (("jax", jtools["protobuf_to_json"].main, "sys_argv"),
                           ("port", t_pb2json.main, "argv")):
        path = str(d / f"{name}.json")
        rc, out, err = _call(main, **{kw: [str(pb), path]})
        assert rc == 0, err
        with open(path) as f:
            outs[name] = (out, f.read(), path)
    return outs


def test_protobuf_to_json_as_the_jax_tool(rules_json):
    assert rules_json["port"][:2] == rules_json["jax"][:2]
    assert "Loaded 2 rules." in rules_json["port"][0]
    doc = json.loads(rules_json["port"][1])
    assert [r["name"] for r in doc["rule"]] == ["taso_rule_0", "taso_rule_1"]
    assert doc["rule"][0]["srcOp"][0]["para"][0]["value"] == "AC_MODE_NONE"
    assert _call(t_pb2json.main, ["only-one-argument"])[0] == 1


@pytest.mark.parametrize("rule", ["taso_rule_0", "taso_rule_1", "no_such_rule"])
def test_substitution_to_dot_as_the_jax_tool(jtools, rules_json, rule):
    path = rules_json["port"][2]
    got = _call(t_subst_dot.main, [path, rule])
    assert got == _call(jtools["substitution_to_dot"].main, sys_argv=[path, rule])
    if rule == "no_such_rule":
        assert got[0] == 1 and "Could not find rule" in got[2]
    else:
        assert got[0] == 0 and got[1].startswith("digraph substitution")
        assert "OP_LINEAR" in got[1]


@pytest.mark.parametrize("argv", [[], ["-e", "3", "-b", "32", "--search-budget", "20",
                                       "--perform-fusion"]], ids=["defaults", "flags"])
def test_arg_parser_as_the_jax_tool(jtools, argv):
    got = _call(t_arg_parser.main, argv)
    assert got == _call(jtools["arg_parser"].main, argv) and got[0] == 0
    if argv:
        cfg = json.loads(got[1])
        assert (cfg["epochs"], cfg["batch_size"], cfg["search_budget"],
                cfg["perform_fusion"]) == (3, 32, 20, True)
