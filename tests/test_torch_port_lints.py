"""The port's source lints (flexflow_tpu_torch/analysis/source_lints.py):
each lint fires on a seeded snippet; the plain-Python lints (LINT002,
LINT003, LINT005, LINT006, LINT007) give the JAX package's diagnostics on
the same snippet (rule id, line, message); the PyTorch counterparts of the
JAX-only ones (LINT001: a host read in a CUDA-graph body; LINT009: a
literal seed in a step body) fire where they should and not on the
neighbouring allowed forms; LINT004, LINT008 and LINT010 keep their
catalog entries; the port's package lints clean; and the command
`python3 -m flexflow_tpu_torch.ffcheck --all-templates --audit-rules
--lint` exits 0 (and 1 on a seeded file)."""

import subprocess
import sys
from pathlib import Path

import pytest

from flexflow_tpu.analysis import source_lints as J
from flexflow_tpu_torch.analysis import source_lints as T

REPO = Path(__file__).resolve().parent.parent

SHARED = {
    "LINT002": ("import x\n"
                "class C:\n"
                "    def f(self, o):\n"
                "        self._cache[id(o)] = 1\n", "pkg/compiler/c.py"),
    "LINT003": ("def f(xs):\n"
                "    for x in set(xs):\n"
                "        print(x)\n", "pkg/compiler/c.py"),
    "LINT005": ("import numpy as np\n"
                "def _fit_epochs(self, it):\n"
                "    for b in it:\n"
                "        loss = step(b)\n"
                "        print(loss.item())\n"
                "        np.asarray(loss)\n", "pkg/core/ffmodel.py"),
    "LINT006": ("def save(tree):\n"
                "    try:\n"
                "        write(tree)\n"
                "    except Exception:\n"
                "        pass\n", "pkg/runtime/supervisor.py"),
    "LINT007": ("import threading\n"
                "class Producer:\n"
                "    def __init__(self):\n"
                "        self._lock = threading.Lock()\n"
                "        self.channel = None\n"
                "        self._t = threading.Thread(target=self._pump)\n"
                "    def _pump(self):\n"
                "        self.count = 1\n", "pkg/runtime/pump.py"),
}


def _key(diags):
    return [(d.rule_id, d.line, d.message) for d in diags]


@pytest.mark.parametrize("rule", sorted(SHARED))
def test_plain_python_lints_give_the_jax_diagnostics(rule):
    src, path = SHARED[rule]
    got = T.lint_source(src, path)
    assert _key(got) == _key(J.lint_source(src, path))
    assert {d.rule_id for d in got} == {rule}


GRAPH_BODY = (
    "def fused_multi_step(instance, params, rng):\n"
    "    loss = step(params)\n"
    "    a = loss.item()\n"            # 3
    "    b = loss.cpu()\n"             # 4
    "    c = loss.tolist()\n"          # 5
    "    d = float(loss)\n"            # 6
    "    e = float(2)\n"               # a constant: allowed
    "    return a, b, c, d, e\n"
    "def decode_window_eager(self, cache, steps: int):\n"
    "    for _ in range(steps):\n"
    "        n = int(cache.sum())\n"   # 11
    "    return n\n"
    "def helper(loss):\n"
    "    return loss.item()\n"         # outside a graph body: allowed
)


def test_lint001_host_reads_in_graph_bodies():
    diags = T.lint_source(GRAPH_BODY, "pkg/local_execution/training_backing.py")
    assert [(d.rule_id, d.line) for d in diags] == [
        ("LINT001", n) for n in (3, 4, 5, 6, 11)]


STEP_BODY = (
    "import torch\n"
    "def _step(self, params, rng):\n"
    "    torch.manual_seed(0)\n"                         # 3
    "    g = torch.Generator().manual_seed(1234)\n"      # 4
    "    rng.manual_seed(seed)\n"                        # derived: allowed
    "    return g\n"
    "def train_step(self, params, rng=None):\n"
    "    rng = rng or torch.Generator().manual_seed(0)\n"  # not a step body: allowed
    "    return self._step(params, rng)\n"
)


def test_lint009_literal_seeds_in_step_bodies():
    diags = T.lint_source(STEP_BODY, "pkg/local_execution/training_backing.py")
    assert [(d.rule_id, d.line) for d in diags] == [("LINT009", 3), ("LINT009", 4)]


def test_the_catalog_keeps_every_rule_with_a_reason_where_the_port_has_none():
    assert sorted(T.LINT_CATALOG) == sorted(J.LINT_CATALOG)
    for rule in ("LINT004", "LINT008", "LINT010"):
        assert "no counterpart in the port" in T.LINT_CATALOG[rule]


def test_the_port_lints_clean():
    assert T.lint_package() == []


def test_ffcheck_command_exits_zero_on_the_port_and_one_on_a_seeded_file(tmp_path):
    cmd = [sys.executable, "-m", "flexflow_tpu_torch.ffcheck"]
    ok = subprocess.run(cmd + ["--all-templates", "--audit-rules", "--lint"], cwd=REPO,
                        capture_output=True, text=True, timeout=300)
    assert ok.returncode == 0, ok.stdout + ok.stderr
    assert "0 error(s)" in ok.stdout
    bad = tmp_path / "bad.py"
    bad.write_text(STEP_BODY)
    out = subprocess.run(cmd + ["--lint", str(bad), "--json"], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 1 and '"LINT009"' in out.stdout
