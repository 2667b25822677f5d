"""Sub-mesh branches in the port (A10, parallel/submesh.py) against the JAX
package's, on the CPU: the two-tower graph of tests/test_submesh.py (split
-> tower A: dense 128, relu, dense 64 / tower B: dense 64 -> add -> head).

- find_branch_partition gives both packages the same islands (by layer
  name and node index);
- on 2 and 4 gloo ranks (each count launched once per session, every group
  and join limited to 120 s), FFConfig(submesh_branches=True) routes
  FFModel's compile to the sub-mesh trainer and records the resource-split
  pricing; from the JAX instance's initial state (carried in by
  interop.ffmodel_state_from_numpy): two SGD steps' losses and every
  island's parameters within 1e-5 of the JAX SubmeshBranchInstance on 2
  and 4 virtual devices, each branch's parameters only on its group of
  ranks; then fit and eval run; Dropout and the run-health flags are
  refused, as in the JAX package.
"""

from __future__ import annotations

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

from test_torch_port_once import once_per_session

REPO = Path(__file__).resolve().parent.parent
BATCH = 16
TOL = 1e-5
JOIN_S = 120


def towers(pkg, batch=BATCH, dropout=0.0):
    """tests/test_submesh.py's _branchy_nonisomorphic_cg, in either package."""
    b = pkg.ComputationGraphBuilder()
    x = b.create_input([batch, 64], name="x")
    t = b.dense(x, 64, use_bias=False, name="fc0")
    a1, a2 = b.split(t, [32, 32], axis=1)
    h1 = b.relu(b.dense(a1, 128, use_bias=False, name="a_w1"))
    if dropout:
        h1 = b.dropout(h1, dropout)
    h1 = b.dense(h1, 64, use_bias=False, name="a_w2")
    h2 = b.dense(a2, 64, use_bias=False, name="b_w1")
    y = b.add(h1, h2, name="merge")
    return b.graph, b.dense(y, 8, use_bias=False, name="head")


def ff_towers(core, device=None, **cfg):
    """The towers through FFModel (tests/test_submesh.py's flag test)."""
    kw = {} if device is None else dict(device=device)
    m = core.FFModel(core.FFConfig(batch_size=BATCH, seed=0, submesh_branches=True, **cfg), **kw)
    x = m.create_tensor([BATCH, 64], name="x")
    t = m.dense(x, 64, use_bias=False, name="fc0")
    a1, a2 = m.split(t, [32, 32], axis=1)
    h1 = m.dense(m.relu(m.dense(a1, 128, use_bias=False, name="a_w1")), 64, use_bias=False,
                 name="a_w2")
    h2 = m.dense(a2, 64, use_bias=False, name="b_w1")
    logits = m.dense(m.add(h1, h2, name="merge"), 8, use_bias=False, name="head")
    m.compile(core.SGDOptimizer(lr=0.05), "sparse_categorical_crossentropy",
              logit_tensor=logits)
    return m


def data(seed=0):
    rs = np.random.RandomState(seed)
    return rs.randn(BATCH, 64).astype(np.float32), rs.randint(0, 8, BATCH).astype(np.int32)


def _islands(cg, part):
    pre, branches, post = part
    name = lambda n: cg.layer_attrs(n).name or f"#{n.idx}"  # noqa: E731
    return (sorted(map(name, pre)), [sorted(map(name, b)) for b in branches],
            sorted(map(name, post)))


def test_find_branch_partition_same_islands():
    from flexflow_tpu import pcg as jpcg
    from flexflow_tpu.parallel.submesh import find_branch_partition as j_find
    from flexflow_tpu_torch import pcg as tpcg
    from flexflow_tpu_torch.parallel.submesh import find_branch_partition

    tcg, _ = towers(tpcg)
    jcg, _ = towers(jpcg)
    t, j = find_branch_partition(tcg), j_find(jcg)
    assert _islands(tcg, t) == _islands(jcg, j)
    assert [sorted(n.idx for n in b) for b in t[1]] == [sorted(n.idx for n in b) for b in j[1]]
    names = _islands(tcg, t)[1]
    assert {"a_w1", "a_w2"} <= set(names[0]) and "b_w1" in names[1]
    assert {"merge", "head"} <= set(_islands(tcg, t)[2])
    chain = tpcg.ComputationGraphBuilder()
    chain.dense(chain.create_input([4, 8], name="x"), 8)
    assert find_branch_partition(chain.graph) is None


def test_dropout_and_run_health_are_refused():
    import torch.distributed as dist

    from flexflow_tpu_torch import core, pcg as tpcg
    from flexflow_tpu_torch.op_attrs.ops import SparseCategoricalCrossEntropyLossAttrs
    from flexflow_tpu_torch.parallel.submesh import SubmeshBranchInstance
    from flexflow_tpu_torch.pcg.optimizer import SGDOptimizerAttrs

    cg, logit = towers(tpcg, dropout=0.1)
    with pytest.raises(ValueError, match="Dropout"):
        SubmeshBranchInstance(cg, logit, SparseCategoricalCrossEntropyLossAttrs(),
                              SGDOptimizerAttrs(lr=0.05))
    assert not dist.is_initialized()
    m = core.FFModel(core.FFConfig(batch_size=BATCH, submesh_branches=True,
                                   metrics_dir="events"), device="cpu")
    m.create_tensor([BATCH, 4], name="x")
    with pytest.raises(ValueError, match="submesh_branches"):
        m._validate_config_flags()


# One rank; argv: rank, world, work dir.
WORKER = textwrap.dedent(
    """
    import json, os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from flexflow_tpu_torch import core
    from flexflow_tpu_torch.interop import ffmodel_state_from_numpy, submesh_params_to_numpy
    from flexflow_tpu_torch.parallel import init_file_group

    torch.set_num_threads(1)
    rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    init_file_group(os.path.join(work, "store"), rank, world, device="cpu", timeout_s=120)
    exec(open(os.path.join(work, "build.py")).read())  # the test's builders
    m = ff_towers(core, device="cpu")
    inst = m.instance
    res = dict(kind=type(inst).__name__, prov=m.search_provenance, groups=inst.branch_ranks)
    # the JAX instance's initial state, carried into this rank's islands
    z = np.load(os.path.join(work, "jax_init.npz"))
    init = {}
    for key in z.files:
        island, k = key.split("/")
        init.setdefault(island, {})[k] = z[key]
    ffmodel_state_from_numpy(m, init, {i: {"step": np.int32(0)} for i in init})
    res["islands"] = sorted(m.params)
    x, y = data()
    losses = []
    for _ in range(2):
        m.params, m.opt_state, loss, _ = inst.train_step(m.params, m.opt_state, {"x": x}, y)
        losses.append(float(loss))
    res["losses"] = losses
    res["steps_counted"] = sorted({int(o["step"]) for o in m.opt_state.values()})
    final = submesh_params_to_numpy(inst, m.params)
    if rank == 0:
        np.savez(os.path.join(work, "port_final.npz"),
                 **{f"{i}/{k}": v for i, p in final.items() for k, v in p.items()})
    res["forward_rows"] = int(inst.forward(m.params, {"x": x}).shape[0])
    perf = m.fit(x=x, y=y, epochs=1, verbose=False)
    res["fit"] = [int(perf.train_all), bool(np.isfinite(perf.sparse_cce_loss))]
    res["eval_all"] = int(m.eval(x=x, y=y).train_all)
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()
    """
)


def _runs(work: Path, world: int) -> dict:
    import inspect

    from flexflow_tpu import pcg as jpcg
    from flexflow_tpu.local_execution import ModelTrainingInstance
    from flexflow_tpu.op_attrs.ops.loss_functions import SparseCategoricalCrossEntropyLossAttrs
    from flexflow_tpu.parallel.submesh import SubmeshBranchInstance
    from flexflow_tpu.pcg.optimizer import SGDOptimizerAttrs

    cg, logits = towers(jpcg)
    loss_attrs, opt_attrs = SparseCategoricalCrossEntropyLossAttrs(), SGDOptimizerAttrs(lr=0.05)
    inst = SubmeshBranchInstance(cg, logits, loss_attrs, opt_attrs,
                                 devices=jax.devices()[:world])
    params, opt_state = inst.initialize(seed=0)
    np.savez(work / "jax_init.npz", **{f"{i}/{k}": np.asarray(v) for i, p in params.items()
                                       for k, v in p.items()})
    x, y = data()
    losses = []
    for _ in range(2):
        params, opt_state, loss, _ = inst.train_step(params, opt_state, {"x": jnp.asarray(x)}, y)
        losses.append(float(loss))
    ref = dict(losses=losses, params={f"{i}/{k}": np.asarray(v) for i, p in params.items()
                                      for k, v in p.items()})
    # the single-program reference of the JAX test
    one = ModelTrainingInstance(cg, logits, loss_attrs, opt_attrs)
    rp, rs = one.initialize(seed=0)
    ref["one_program"] = []
    for _ in range(2):
        rp, rs, rl, _ = one.train_step(rp, rs, {"x": jnp.asarray(x)}, jnp.asarray(y))
        ref["one_program"].append(float(rl))

    (work / "build.py").write_text(
        f"BATCH = {BATCH}\n" + "".join(inspect.getsource(f) for f in (ff_towers, data)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(world), str(work)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    errors = []
    for r, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=JOIN_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        if p.returncode != 0:
            errors.append(f"rank {r}: {err[-3000:]}")
    assert not errors, "\n".join(errors)
    ranks = [json.loads((work / f"rank{r}.json").read_text()) for r in range(world)]
    return dict(ref=ref, ranks=ranks, final=dict(np.load(work / "port_final.npz")))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return {world: once_per_session(tmp_path_factory, f"submesh_ranks{world}",
                                    lambda w, world=world: _runs(w, world))
            for world in (2, 4)}


@pytest.mark.parametrize("world", [2, 4])
def test_two_steps_match_the_jax_instance(runs, world):
    r = runs[world]
    for rank in r["ranks"]:
        np.testing.assert_allclose(rank["losses"], r["ref"]["losses"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(r["ref"]["losses"], r["ref"]["one_program"], rtol=2e-5)
    assert set(r["final"]) == set(r["ref"]["params"])
    for k, v in r["ref"]["params"].items():
        np.testing.assert_allclose(r["final"][k], v, rtol=TOL, atol=TOL, err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
def test_branch_parameters_live_only_on_their_group(runs, world):
    groups = runs[world]["ranks"][0]["groups"]
    half = world // 2
    assert groups == [list(range(half)), list(range(half, world))]
    for rank, r in enumerate(runs[world]["ranks"]):
        mine = 0 if rank < half else 1
        assert r["islands"] == sorted(["pre", "post", f"branch{mine}"])
        assert r["steps_counted"] == [2] and r["forward_rows"] == BATCH


@pytest.mark.parametrize("world", [2, 4])
def test_ffmodel_flag_routes_fits_and_evals(runs, world):
    for rank in runs[world]["ranks"]:
        assert rank["kind"] == "SubmeshBranchInstance"
        assert rank["prov"]["resource_splits_priced"] and rank["prov"]["estimated_ms"] > 0
        assert rank["fit"] == [BATCH, True] and rank["eval_all"] == BATCH
