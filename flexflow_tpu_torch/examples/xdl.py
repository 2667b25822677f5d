"""XDL training example (port of examples/xdl.py; reference
examples/cpp/XDL/xdl.cc): summed embedding bags of sparse features,
concatenated, then an MLP with one sigmoid layer, mean squared error.

Run: python -m flexflow_tpu_torch.examples.xdl -b 8 --steps 2
"""

from __future__ import annotations

import math

import numpy as np

from flexflow_tpu_torch.core import Activation, FFConfig, FFModel, SGDOptimizer
from flexflow_tpu_torch.examples import example_parser
from flexflow_tpu_torch.op_attrs.datatype import DataType
from flexflow_tpu_torch.op_attrs.ops import AggregateSpec
from flexflow_tpu_torch.pcg.initializer import NormInitializerAttrs, UniformInitializerAttrs


def create_mlp(m, t, ln, sigmoid_layer):
    """xdl.cc:38-59."""
    for i in range(len(ln) - 1):
        std = math.sqrt(2.0 / (ln[i + 1] + ln[i]))
        act = Activation.SIGMOID if i == sigmoid_layer else Activation.RELU
        t = m.dense(t, ln[i + 1], activation=act, use_bias=False,
                    kernel_initializer=NormInitializerAttrs(seed=i, mean=0, stddev=std))
    return t


def create_emb(m, s, input_dim, output_dim, idx):
    """xdl.cc:61-75."""
    rng = math.sqrt(1.0 / input_dim)
    return m.embedding(s, input_dim, output_dim, aggr=AggregateSpec.SUM,
                       kernel_initializer=UniformInitializerAttrs(seed=idx, min_val=-rng,
                                                                  max_val=rng))


def main(argv=None):
    p = example_parser()
    p.add_argument("--embedding-bag-size", type=int, default=1)
    p.add_argument("--sparse-feature-size", type=int, default=64)
    p.add_argument("--num-embeddings", type=int, default=4, help="number of sparse features")
    p.add_argument("--embedding-entries", type=int, default=1000)
    p.add_argument("--mlp-top", type=int, nargs="+", default=[256, 128, 64, 1])
    p.add_argument("--steps", type=int, default=4)
    args = p.parse_args(argv)
    cfg = FFConfig.from_args(args)

    m = FFModel(cfg, device=args.device)
    sparse = [m.create_tensor([cfg.batch_size, args.embedding_bag_size], dtype=DataType.INT32,
                              name=f"sparse{i}")
              for i in range(args.num_embeddings)]
    ly = [create_emb(m, s, args.embedding_entries, args.sparse_feature_size, i)
          for i, s in enumerate(sparse)]
    z = m.concat(ly, axis=-1)  # interact_features
    mlp = [args.num_embeddings * args.sparse_feature_size] + args.mlp_top
    pred = create_mlp(m, z, mlp, len(mlp) - 2)
    m.compile(SGDOptimizer(lr=0.01), "mean_squared_error", metrics=["mean_squared_error"],
              logit_tensor=pred)

    n = args.steps * cfg.batch_size
    rs = np.random.RandomState(cfg.seed)
    xs = {f"sparse{i}": rs.randint(0, args.embedding_entries,
                                   (n, args.embedding_bag_size)).astype(np.int32)
          for i in range(args.num_embeddings)}
    ys = rs.rand(n, 1).astype(np.float32)
    perf = m.fit(x=xs, y=ys, epochs=cfg.epochs)
    print(f"train mse = {perf.mse_loss / max(perf.train_all, 1):.6f}")


if __name__ == "__main__":
    main()
