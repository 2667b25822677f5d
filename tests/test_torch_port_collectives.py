"""The four parallel ops as differentiable collectives
(flexflow_tpu_torch.parallel.collectives) on 2 gloo processes, each op's
forward and backward against the dense computation it stands for.

The trainers' invariant: on every rank the gradient of a piece is the
global loss's full gradient with respect to that piece. So each case takes
a global loss, lets each rank compute its share of it on its pieces, and
checks that autograd through the op gives every rank the full gradient of
its piece (or, where ranks did different work on one piece, that the
gradient summed by sum_grad is the whole). Values are f64 from a numpy
seed, compared within 1e-12."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
RANKS = 2

# One rank: argv rank, work dir. Global values from seed 0, the same on
# every rank; each rank keeps its piece as the mesh's axis d0 says.
WORKER = textwrap.dedent(
    """
    import os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from flexflow_tpu_torch.parallel import MachineMesh, init_file_group
    from flexflow_tpu_torch.parallel import collectives as C
    from flexflow_tpu_torch.parallel.sharding import TensorSharding

    rank, work = int(sys.argv[1]), sys.argv[2]
    init_file_group(os.path.join(work, "store"), rank, 2, device="cpu")
    mesh = MachineMesh.for_devices(2)
    rs = np.random.RandomState(0)
    g = lambda *shape: torch.tensor(rs.randn(*shape))
    X, W, P, V = g(4, 6), g(4, 6), g(2, 3), g(2, 5)
    out = {}

    # Repartition: the rank's columns; a loss on the pieces
    x = X.clone().requires_grad_(True)
    y = C.narrow(x, 1, mesh, ("d0",))
    (y * W[:, 3 * rank:3 * rank + 3]).sum().backward()
    out["narrow_y"], out["narrow_dx"] = y.detach().numpy(), x.grad.numpy()

    # Combine: the whole from the pieces; the loss duplicated on both ranks
    x = X[:, 3 * rank:3 * rank + 3].clone().requires_grad_(True)
    y = C.all_gather(x, 1, mesh, ("d0",))
    (y * W).sum().backward()
    out["gather_y"], out["gather_dx"] = y.detach().numpy(), x.grad.numpy()

    # Reduction: partial sums into their sum
    p = P[rank].clone().requires_grad_(True)
    y = C.sum_partials(p, mesh, ("d0",))
    (y * W[0, :3]).sum().backward()
    out["sum_y"], out["sum_dp"] = y.detach().numpy(), p.grad.numpy()

    # Replicate's consumer: each rank does its own work on one copy
    x = V[0].clone().requires_grad_(True)
    y = C.sum_grad(x, mesh, ("d0",))
    (y * V[1] * (rank + 1)).sum().backward()
    out["copy_y"], out["copy_dx"] = y.detach().numpy(), x.grad.numpy()

    # BatchNorm's statistics: an all-reduce inside the forward
    x = P[rank].clone().requires_grad_(True)
    s = C.all_reduce_sum(x, mesh.group_of(("d0",))[0], mesh.counts)
    (s * W[rank, :3]).sum().backward()
    out["stat_s"], out["stat_dx"] = s.detach().numpy(), x.grad.numpy()

    # a reshard that sums partials and moves a dim's pieces
    src = TensorSharding(((), ("d0",)), ())
    dst = TensorSharding((("d0",), ()), ())
    x = X[:, 3 * rank:3 * rank + 3].clone().requires_grad_(True)
    y = C.reshard(x, src, dst, mesh)
    (y * W[2 * rank:2 * rank + 2]).sum().backward()
    out["reshard_y"], out["reshard_dx"] = y.detach().numpy(), x.grad.numpy()

    # gradient buckets: one all-reduce per set of axes
    buckets = C.bucket_all_reduce(mesh, {("d0",): [P[rank], V[rank]], (): [X]})
    out["bucket_p"], out["bucket_v"] = buckets[("d0",)][0].numpy(), buckets[("d0",)][1].numpy()
    out["bucket_local"] = buckets[()][0].numpy()
    out["counts"] = np.array([mesh.counts["all_reduce"], mesh.counts["all_gather"]])
    np.savez(os.path.join(work, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()
    """
)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("collectives")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(work)], cwd=REPO,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(RANKS)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
    rs = np.random.RandomState(0)
    X, W, P, V = rs.randn(4, 6), rs.randn(4, 6), rs.randn(2, 3), rs.randn(2, 5)
    return [dict(np.load(work / f"rank{r}.npz")) for r in range(RANKS)], dict(X=X, W=W, P=P, V=V)


def close(a, b):
    np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)


def test_repartition_narrows_and_all_gathers_the_gradient(ranks):
    out, g = ranks
    for r, o in enumerate(out):
        close(o["narrow_y"], g["X"][:, 3 * r:3 * r + 3])
        close(o["narrow_dx"], g["W"])  # the loss over both pieces, on every rank


def test_combine_all_gathers_and_narrows_the_gradient(ranks):
    out, g = ranks
    for r, o in enumerate(out):
        close(o["gather_y"], g["X"])
        close(o["gather_dx"], g["W"][:, 3 * r:3 * r + 3])  # not summed over duplicates


def test_reduction_sums_partials_with_an_identity_backward(ranks):
    out, g = ranks
    for o in out:
        close(o["sum_y"], g["P"].sum(0))
        close(o["sum_dp"], g["W"][0, :3])


def test_a_replicated_copy_sums_the_gradients_of_different_work(ranks):
    out, g = ranks
    for o in out:
        close(o["copy_y"], g["V"][0])
        close(o["copy_dx"], g["V"][1] * (1 + 2))


def test_statistics_all_reduce_carries_every_ranks_share_back(ranks):
    out, g = ranks
    for o in out:
        close(o["stat_s"], g["P"].sum(0))
        close(o["stat_dx"], g["W"][0, :3] + g["W"][1, :3])


def test_reshard_moves_a_dims_pieces(ranks):
    out, g = ranks
    for r, o in enumerate(out):
        close(o["reshard_y"], g["X"][2 * r:2 * r + 2])
        # both ranks' row blocks reach each column piece: the full gradient
        close(o["reshard_dx"], g["W"][:, 3 * r:3 * r + 3])


def test_buckets_sum_over_their_axes_with_one_all_reduce_each(ranks):
    out, g = ranks
    for r, o in enumerate(out):
        close(o["bucket_p"], g["P"].sum(0))
        close(o["bucket_v"], g["V"].sum(0))
        close(o["bucket_local"], g["X"])
        # sum_partials, sum_grad, all_reduce_sum (twice), one bucket; gathers:
        # narrow's backward, all_gather, the reshard's gather and backward
        assert list(o["counts"]) == [5, 4]
    assert json.dumps(out[0]["counts"].tolist()) == json.dumps(out[1]["counts"].tolist())
