"""The multi-process runtime (flexflow_tpu_torch/runtime/distributed.py,
the port of flexflow_tpu/runtime/distributed.py), on 2 gloo processes on
the CPU:

- `initialize()` from FLEXFLOW_TPU_COORDINATOR, FLEXFLOW_TPU_NUM_PROCESSES
  and FLEXFLOW_TPU_PROCESS_ID (a localhost TCP store): process_count,
  process_index, is_multiprocess, broadcast_json round-tripping a
  document; and single-process with nothing configured;
- one `torchrun --standalone --nproc_per_node 2` launch of a tiny searched
  FFModel fit with FLEXFLOW_TPU_AUTO_DISTRIBUTED=1 (torchrun's env://):
  the search runs on rank 0 alone (run_search_on_host_0's count), and the
  losses and parameters are bitwise those of the same job over a `file://`
  store (parallel.init_file_group)."""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
from test_torch_port_once import once_per_session

REPO = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(**extra):
    """The environment of a rank: the repo on the path (a script's own
    directory is, its working directory is not)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update({k: str(v) for k, v in extra.items()}, PYTHONPATH=str(REPO))
    return env


INIT_WORKER = textwrap.dedent(
    """
    import json, sys
    import torch.distributed as dist
    from flexflow_tpu_torch.runtime import distributed as D

    out = sys.argv[1]
    D.initialize(device="cpu")
    D.initialize(device="cpu")  # idempotent
    doc = D.broadcast_json({"plan": [1, 2.5, "x"], "from": D.process_index()}
                           if D.process_index() == 0 else None)
    res = dict(count=D.process_count(), index=D.process_index(), multi=D.is_multiprocess(),
               rank=dist.get_rank(), backend=dist.get_backend(), doc=doc)
    dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(res, f)
    """
)


def test_initialize_from_the_flexflow_variables(tmp_path):
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", INIT_WORKER, str(tmp_path / f"rank{r}.json")], cwd=REPO,
        env=_env(FLEXFLOW_TPU_COORDINATOR=f"localhost:{port}", FLEXFLOW_TPU_NUM_PROCESSES=2,
                 FLEXFLOW_TPU_PROCESS_ID=r),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
    for r in range(2):
        got = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert got == dict(count=2, index=r, multi=True, rank=r, backend="gloo",
                           doc={"plan": [1, 2.5, "x"], "from": 0})


def test_nothing_configured_stays_single_process(monkeypatch):
    import torch.distributed as dist

    from flexflow_tpu_torch.runtime import distributed as D

    for var in ("FLEXFLOW_TPU_COORDINATOR", "FLEXFLOW_TPU_AUTO_DISTRIBUTED"):
        monkeypatch.delenv(var, raising=False)
    D.initialize(device="cpu")
    assert not dist.is_initialized()
    assert (D.process_count(), D.process_index(), D.is_multiprocess()) == (1, 0, False)
    assert D.broadcast_json({"a": 1}) == {"a": 1}
    calls = D.search_calls
    assert D.run_search_on_host_0(lambda: ("pcg", {}, 1.0)) == ("pcg", {}, 1.0)
    assert D.search_calls == calls + 1


# The searched job: argv: output path, "torchrun" or "file" (then rank and
# the store's path follow).
JOB = textwrap.dedent(
    """
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from flexflow_tpu_torch import core
    from flexflow_tpu_torch.runtime import distributed as D

    torch.set_num_threads(1)
    out, mode = sys.argv[1], sys.argv[2]
    if mode == "torchrun":
        D.initialize(backend="gloo", device="cpu")
    else:
        from flexflow_tpu_torch.parallel import init_file_group
        init_file_group(sys.argv[4], int(sys.argv[3]), 2, device="cpu")
    m = core.FFModel(core.FFConfig(batch_size=64, seed=0, print_freq=0, search_budget=2),
                     device="cpu")
    x = m.create_tensor([64, 256], name="x")
    m.dense(m.relu(m.dense(x, 2048, use_bias=False, name="fc1")), 16, use_bias=False,
            name="out")
    m.compile(core.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy")
    losses, step = [], m.instance.train_step

    def recorded(*a, **k):
        res = step(*a, **k)
        losses.append(float(res[2]))
        return res

    m.instance.train_step = recorded
    rs = np.random.RandomState(0)
    xs, ys = rs.randn(128, 256).astype(np.float32), rs.randint(0, 16, 128)
    m.fit(x=xs, y=ys, epochs=2, shuffle=True, verbose=False)
    params = {n: m.get_parameter_by_name(n).get_weights(m).tolist()
              for n in ("fc1.weight0", "out.weight0")}
    res = dict(rank=dist.get_rank(), world=dist.get_world_size(), searches=D.search_calls,
               degrees=m.search_provenance["parallel_degrees"], losses=losses, params=params)
    dist.destroy_process_group()
    with open(out + f".rank{res['rank']}.json", "w") as f:
        json.dump(res, f)
    """
)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    return once_per_session(tmp_path_factory, "torchrun", _jobs)


def _jobs(work):
    job = work / "job.py"
    job.write_text(JOB)
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         str(job), str(work / "torchrun"), "torchrun"],
        cwd=REPO, env=_env(FLEXFLOW_TPU_AUTO_DISTRIBUTED=1, OMP_NUM_THREADS=1),
        capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stderr[-4000:]
    procs = [subprocess.Popen([sys.executable, str(job), str(work / "file"), "file", str(r),
                               str(work / "store")], cwd=REPO, env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err
    return {mode: [json.loads((work / f"{mode}.rank{r}.json").read_text()) for r in range(2)]
            for mode in ("torchrun", "file")}


def test_torchrun_launch_searches_on_rank_0_alone(jobs):
    ranks = jobs["torchrun"]
    assert [r["rank"] for r in ranks] == [0, 1] and all(r["world"] == 2 for r in ranks)
    assert [r["searches"] for r in ranks] == [1, 0]
    assert ranks[0]["degrees"] and ranks[0]["degrees"] == ranks[1]["degrees"]


def test_torchrun_job_is_bitwise_the_file_store_job(jobs):
    for got, want in zip(jobs["torchrun"], jobs["file"]):
        assert len(got["losses"]) == 4 and np.all(np.isfinite(got["losses"]))
        assert got["losses"] == want["losses"]
        assert got["params"] == want["params"]
        assert got["degrees"] == want["degrees"]
