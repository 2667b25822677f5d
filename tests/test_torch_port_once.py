"""once_per_session: a fixture's expensive result (the JAX references and
the port's rank processes) built once per test session, even when
pytest-xdist spreads the fixture's tests over several workers, each of
which would otherwise build it again for its own module scope.

The first worker to ask for a key builds the result and leaves it, pickled,
in the session's shared temporary directory; the others wait for it and
read it. A build that fails leaves its message instead, and every worker
that asks raises it. Without xdist the result is built directly."""

import os
import pickle
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

WAIT_S = 900


class _Failed:
    def __init__(self, message: str) -> None:
        self.message = message


def _write(path: Path, obj) -> None:
    tmp = path.with_suffix(f".tmp{os.getpid()}")
    tmp.write_bytes(pickle.dumps(obj))
    os.replace(tmp, path)


def _read(path: Path, key: str):
    deadline = time.monotonic() + WAIT_S
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{key}: no result after {WAIT_S} s")
        time.sleep(0.2)
    out = pickle.loads(path.read_bytes())
    if isinstance(out, _Failed):
        raise RuntimeError(f"{key}: the worker that built it failed: {out.message}")
    return out


def build_once(root: Path, key: str, compute):
    """compute() once for `key` among the processes that share `root`."""
    root.mkdir(parents=True, exist_ok=True)
    done = root / f"{key}.pkl"
    try:
        fd = os.open(root / f"{key}.lock", os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        return _read(done, key)
    os.close(fd)
    try:
        out = compute()
    except BaseException as e:
        _write(done, _Failed(f"{type(e).__name__}: {e}"))
        raise
    _write(done, out)
    return out


def once_per_session(tmp_path_factory, key: str, compute):
    """compute(work) -> a picklable result, `work` a fresh directory: built
    once per session across xdist workers (see the module docstring)."""
    if "PYTEST_XDIST_WORKER" not in os.environ:
        return compute(tmp_path_factory.mktemp(key))
    root = tmp_path_factory.getbasetemp().parent / "once_per_session"
    return build_once(root, key, lambda: compute(tmp_path_factory.mktemp(key)))


def test_the_other_processes_read_the_first_ones_result(tmp_path):
    """Three processes race for one key: one builds (counted by a file
    each build appends to), the others read its result."""
    script = textwrap.dedent(
        f"""
        import sys, time
        sys.path.insert(0, {str(Path(__file__).parent)!r})
        from pathlib import Path
        from test_torch_port_once import build_once
        root = Path(sys.argv[1])

        def compute():
            with open(root / "builds", "a") as f:
                f.write("x")
            time.sleep(0.5)
            return {{"value": 42}}

        print(build_once(root / "shared", "k", compute)["value"])
        """
    )
    procs = [subprocess.Popen([sys.executable, "-c", script, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=60) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert [o.strip() for o, _ in outs] == ["42"] * 3
    assert (tmp_path / "builds").read_text() == "x"


def test_a_failed_build_raises_in_every_reader(tmp_path):
    def fail():
        raise ValueError("no")

    with pytest.raises(ValueError):
        build_once(tmp_path, "k", fail)
    with pytest.raises(RuntimeError, match="ValueError: no"):
        build_once(tmp_path, "k", lambda: 1)
