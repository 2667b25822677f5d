"""DLRM training example (port of examples/dlrm.py; reference
examples/cpp/DLRM/dlrm.cc): a bottom MLP over dense features, one embedding
table per sparse feature, their concatenation, a top MLP ending in a
sigmoid, mean squared error on seeded clicks.

Run (smoke): python -m flexflow_tpu_torch.examples.dlrm -b 8 --steps 1 --num-sparse 2 \\
             --embedding-entries 64 --embedding-dim 8 --dense-dim 4 --bottom-mlp 16-8 \\
             --top-mlp 24-8-1
"""

from __future__ import annotations

import numpy as np

from flexflow_tpu_torch.core import Activation, FFConfig, FFModel, SGDOptimizer
from flexflow_tpu_torch.examples import example_parser
from flexflow_tpu_torch.op_attrs.datatype import DataType


def mlp(m, x, dims, final_activation=None):
    for i, d in enumerate(dims):
        act = final_activation if i == len(dims) - 1 else Activation.RELU
        x = m.dense(x, d, activation=act)
    return x


def main(argv=None):
    p = example_parser()
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--num-sparse", type=int, default=8, help="embedding tables")
    p.add_argument("--embedding-entries", type=int, default=10000)
    p.add_argument("--embedding-dim", type=int, default=64)
    p.add_argument("--dense-dim", type=int, default=16)
    p.add_argument("--bottom-mlp", type=str, default="512-256-64")
    p.add_argument("--top-mlp", type=str, default="576-512-256-1")
    args = p.parse_args(argv)
    cfg = FFConfig.from_args(args)
    bottom = [int(d) for d in args.bottom_mlp.split("-")]
    top = [int(d) for d in args.top_mlp.split("-")]
    if bottom[-1] != args.embedding_dim:
        raise ValueError("the bottom MLP must end at the embedding dim (dlrm.cc interaction)")

    m = FFModel(cfg, device=args.device)
    dense_in = m.create_tensor([cfg.batch_size, args.dense_dim], name="dense_features")
    sparse_ins = [m.create_tensor([cfg.batch_size, 1], dtype=DataType.INT32, name=f"sparse{i}")
                  for i in range(args.num_sparse)]
    embeddings = [m.embedding(s, args.embedding_entries, args.embedding_dim, name=f"emb{i}")
                  for i, s in enumerate(sparse_ins)]
    # embedding output is [batch, 1, dim] (one id per table) -> flatten
    embeddings = [m.reshape(e, [cfg.batch_size, args.embedding_dim]) for e in embeddings]
    x = mlp(m, dense_in, bottom)
    interact = m.concat(embeddings + [x], axis=1)
    logit = mlp(m, interact, top, final_activation=Activation.SIGMOID)
    m.compile(SGDOptimizer(lr=cfg.learning_rate), "mean_squared_error",
              metrics=["mean_squared_error"], logit_tensor=logit)

    n = args.steps * cfg.batch_size
    rs = np.random.RandomState(cfg.seed)
    feeds = {"dense_features": rs.randn(n, args.dense_dim).astype(np.float32)}
    for i in range(args.num_sparse):
        feeds[f"sparse{i}"] = rs.randint(0, args.embedding_entries, (n, 1)).astype(np.int32)
    clicks = rs.randint(0, 2, (n, 1)).astype(np.float32)
    perf = m.fit(x=feeds, y=clicks, epochs=cfg.epochs)
    print(f"train mse = {perf.mse_loss / max(perf.train_all, 1):.4f}")


if __name__ == "__main__":
    main()
