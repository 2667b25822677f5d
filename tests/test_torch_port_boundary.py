"""The PyTorch port stands alone: it imports nothing of jax or of the JAX
package, and its entry points run on CUDA unless told otherwise."""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from flexflow_tpu_torch.core import FFConfig, FFModel
from flexflow_tpu_torch.kernels import flash_attention as tfa
from flexflow_tpu_torch.local_execution import ModelTrainingInstance, resolve_device
from flexflow_tpu_torch.models import build_flagship_cg
from flexflow_tpu_torch.op_attrs.ops import SparseCategoricalCrossEntropyLossAttrs
from flexflow_tpu_torch.pcg import AdamOptimizerAttrs
from flexflow_tpu_torch.serving import (
    ServingLMConfig,
    ServingMemorySpec,
    ServingProgram,
    build_serving_lm,
)

REPO = Path(__file__).resolve().parent.parent
PORT_EXAMPLES = ("mlp", "transformer", "bert", "split_test", "candle_uno", "dlrm", "xdl",
                 "alexnet", "resnet", "resnext50", "inception")
FORBIDDEN = ("jax", "jaxlib", "flexflow_tpu")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_port_runs_a_step_with_jax_and_the_jax_package_refused():
    """A single-device step, then a data-parallel one in a one-rank gloo
    group, from the same parameters and batch, then a sequence-parallel
    step of a causal parallel transformer through its ring of one, then a
    few requests served through the serving engine with its watchdog and
    a metrics stream, a serving plan searched, verified and served over a
    mesh of one rank, then an MLP built, compiled, fit and evaluated
    through FFModel, and fit again in fused windows of 3 steps through the
    windowed input pipeline (runtime/cuda_graph.py's CPU path)."""
    script = textwrap.dedent(
        """
        import sys
        import importlib.abc

        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if any(name == f or name.startswith(f + ".") for f in %r):
                    raise ImportError(f"refused import of {name}")
                return None

        sys.meta_path.insert(0, Refuse())
        import numpy as np
        from flexflow_tpu_torch.local_execution import ModelTrainingInstance
        from flexflow_tpu_torch.models import build_flagship_cg
        from flexflow_tpu_torch.op_attrs.ops import SparseCategoricalCrossEntropyLossAttrs
        from flexflow_tpu_torch.pcg import AdamOptimizerAttrs
        import flexflow_tpu_torch.interop  # noqa: F401

        graph, logits = build_flagship_cg(batch=2, seq=64, embed=256, heads=2, layers=1, vocab=64)
        inst = ModelTrainingInstance(graph, logits, SparseCategoricalCrossEntropyLossAttrs(),
                                     AdamOptimizerAttrs(alpha=1e-3), device="cpu")
        params, opt = inst.initialize(seed=0)
        rs = np.random.RandomState(0)
        x = rs.randn(2, 64, 256).astype(np.float32)
        y = rs.randint(0, 64, (2, 64))
        _, _, loss, _ = inst.train_step(params, opt, {"x": x}, y)
        assert np.isfinite(float(loss))

        import os, tempfile
        import torch.distributed as dist
        from flexflow_tpu_torch.parallel import DataParallelTrainingInstance, init_file_group

        init_file_group(os.path.join(tempfile.mkdtemp(), "store"), 0, 1, device="cpu")
        dp = DataParallelTrainingInstance(graph, logits, SparseCategoricalCrossEntropyLossAttrs(),
                                          AdamOptimizerAttrs(alpha=1e-3), device="cpu")
        _, _, dp_loss, _ = dp.train_step(*dp.initialize(seed=0), {"x": x}, y)
        dist.destroy_process_group()
        # one gradient bucket (the bucket plan) and the loss's bucket
        assert abs(float(dp_loss) - float(loss)) < 1e-5 and dp.all_reduces == 2
        assert dp.step_collectives()["all_reduce"] == len(dp.buckets) + 1 == 2

        from flexflow_tpu_torch.models import ParallelTransformerConfig, build_parallel_transformer
        from flexflow_tpu_torch.parallel import DistributedTrainingInstance, MachineMesh

        init_file_group(os.path.join(tempfile.mkdtemp(), "store"), 0, 1, device="cpu")
        cfg = ParallelTransformerConfig(batch_size=2, sequence_length=128, num_features=128,
                                        num_heads=2, num_layers=1, vocab_size=64,
                                        data_parallel_degree=1, tensor_parallel_degree=1,
                                        causal=True)
        pcg, logits = build_parallel_transformer(cfg)
        sp = DistributedTrainingInstance(pcg, logits, SparseCategoricalCrossEntropyLossAttrs(),
                                         AdamOptimizerAttrs(alpha=1e-3), MachineMesh(1, 1),
                                         device="cpu")
        xs = rs.randn(2, 128, 128).astype(np.float32)
        _, _, sp_loss, _ = sp.train_step(*sp.initialize(seed=0), {"x": xs}, rs.randint(0, 64, (2, 128)))
        dist.destroy_process_group()
        # a mesh of one rank issues no collective
        assert np.isfinite(float(sp_loss)) and sp.all_reduces == 0

        from flexflow_tpu_torch.observability.metrics import read_run_events
        from flexflow_tpu_torch.runtime.fault import FaultSchedule
        from flexflow_tpu_torch.serving import (ServeRequest, ServingEngine, ServingLMConfig,
                                                ServingMemorySpec, ServingProgram,
                                                build_serving_lm)

        cg, _ = build_serving_lm(ServingLMConfig(), 2, 1)
        prog = ServingProgram(cg, ServingMemorySpec(2, 16), device="cpu")
        metrics = tempfile.mkdtemp()
        eng = ServingEngine(prog, window_steps=2, watchdog_factor=50.0,
                            watchdog_min_budget_ms=1000.0, metrics_dir=metrics)
        for i in range(3):
            eng.submit(ServeRequest(f"r{i}", rs.randint(0, 64, 5).astype(np.int32), 4))
        recs = eng.run()
        eng.close()
        assert sorted(len(r.tokens) for r in recs) == [4, 4, 4]
        assert len(read_run_events(metrics, "serve_request")) == 3
        assert FaultSchedule.parse("seed=1;sites=hang;rate=0.5").fire_steps("hang", 1, 10)

        from flexflow_tpu_torch.analysis.memory_analysis import verify_memory
        from flexflow_tpu_torch.pcg.machine_view import MachineSpecification
        from flexflow_tpu_torch.serving.plan import ServingWorkload, optimize_serving_plan

        spec2 = MachineSpecification(1, 1, 2, 1.0, 2.0)
        plan = optimize_serving_plan(lambda b, s: build_serving_lm(ServingLMConfig(), b, s),
                                     spec2, ServingWorkload(4, 4, 2), budget=1, device="cpu")
        assert verify_memory(plan.decode.pcg, spec2, plan.decode.machine_mapping,
                             hbm_bytes=2**30, serving=plan.cache_spec)[1] == []
        init_file_group(os.path.join(tempfile.mkdtemp(), "store"), 0, 1, device="cpu")
        meshed = ServingProgram(plan.decode.pcg, plan.cache_spec, mapping=plan.decode.machine_mapping,
                                machine_mesh=MachineMesh(1, 1), device="cpu")
        meshed_eng = ServingEngine(meshed, window_steps=2)
        meshed_eng.submit(ServeRequest("m0", rs.randint(0, 64, 4).astype(np.int32), 3))
        assert [len(r.tokens) for r in meshed_eng.run()] == [3]
        dist.destroy_process_group()

        from flexflow_tpu_torch.core import Activation, FFConfig, FFModel, SGDOptimizer

        m = FFModel(FFConfig(batch_size=8, print_freq=0), device="cpu")
        t = m.dense(m.create_tensor([8, 32], name="x"), 16, activation=Activation.RELU)
        m.softmax(m.dense(m.dropout(t, 0.1), 4))
        m.compile(SGDOptimizer(lr=0.1), "categorical_crossentropy", metrics=["accuracy"])
        xs = rs.randn(32, 32).astype(np.float32)
        ys = np.eye(4, dtype=np.float32)[rs.randint(0, 4, 32)]
        perf = m.fit(xs, ys, epochs=2, verbose=False)
        assert perf.train_all == 64 and m.eval(xs, ys).train_all == 32
        m.config.steps_per_dispatch = 3
        perf = m.fit(xs, ys, epochs=2, verbose=False)
        assert perf.train_all == 64 and int(m.opt_state["step"]) == 16
        import flexflow_tpu_torch.runtime.cuda_graph  # noqa: F401

        cnn = FFModel(FFConfig(batch_size=2, print_freq=0), device="cpu")
        img = cnn.create_tensor([2, 3, 8, 8], name="image")
        a = cnn.pool2d(cnn.conv2d(img, 4, 3, 3, 1, 1, 1, 1, groups=1), 2, 2, 2, 2, 0, 0)
        b = cnn.pool2d(cnn.batch_norm(cnn.conv2d(img, 4, 3, 3, 2, 2, 1, 1)), 1, 1, 1, 1, 0, 0,
                       pool_type="avg")
        t = cnn.flat(cnn.concat([a, b], axis=1))
        cnn.dense(cnn.reshape(cnn.split(t, [64, 64], axis=1)[0], [2, 64]), 3)
        cnn.compile(SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy")
        assert cnn.fit(rs.randn(4, 3, 8, 8).astype(np.float32), rs.randint(0, 3, 4),
                       verbose=False).train_all == 4

        import contextlib, io
        from flexflow_tpu_torch.examples import split_test
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            split_test.main(["-b", "4", "--steps", "1", "--device", "cpu"])
        assert "THROUGHPUT" in printed.getvalue()
        assert not any(m == "jax" or m.startswith(("jax.", "flexflow_tpu."))
                       or m == "flexflow_tpu" for m in sys.modules)
        print("ok", float(loss))
        """ % (FORBIDDEN,)
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_sources_import_nothing_of_jax_or_the_jax_package():
    files = sorted((REPO / "flexflow_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    scanned = {str(f.relative_to(REPO / "flexflow_tpu_torch")) for f in files[:-1]}
    for module in ("serving/kv_cache.py", "serving/model.py", "serving/program.py",
                   "serving/engine.py", "runtime/fault.py", "runtime/supervisor.py",
                   "observability/metrics.py", "analysis/memory_accounting.py",
                   "analysis/memory_analysis.py", "analysis/diagnostics.py", "serving/plan.py",
                   "core/ffmodel.py", "core/dataloader.py", "core/optimizers.py",
                   "core/initializers.py", "core/__init__.py", "kernels/metrics.py",
                   "local_execution/config.py", "runtime/cuda_graph.py",
                   "op_attrs/ops/conv_ops.py", "op_attrs/ops/shape_ops.py",
                   "models/transformer.py", "models/bert.py", "models/candle_uno.py",
                   "models/inception_v3.py", "models/split_test.py", "examples/__init__.py",
                   *(f"examples/{name}.py" for name in PORT_EXAMPLES)):
        assert module in scanned
    bad = [(str(f.relative_to(REPO)), m) for f in files for m in _imports(f) if _forbidden(m)]
    assert bad == []


def test_entry_points_default_to_cuda_and_never_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    graph, logits = build_flagship_cg(batch=2, seq=64, embed=256, heads=2, layers=1, vocab=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelTrainingInstance(graph, logits, SparseCategoricalCrossEntropyLossAttrs(),
                              AdamOptimizerAttrs(alpha=1e-3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    cg, _ = build_serving_lm(ServingLMConfig(), 2, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingProgram(cg, ServingMemorySpec(2, 16))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FFModel(FFConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FFModel.from_computation_graph(graph, logits)
    assert resolve_device("cpu") == torch.device("cpu")


def test_wrappers_raise_off_the_cpu_instead_of_falling_back():
    q = torch.empty(1, 64, 128, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        tfa.flash_fwd(q, q, q, 1)
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        tfa.flash_delta(q, q, 1)
