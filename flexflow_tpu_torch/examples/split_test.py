"""split_test: a dense layer split in two branches that join again (port of
examples/split_test.py; reference examples/cpp/split_test). With
--branch-stacking a searched compile (over several ranks) stacks the two
isomorphic branches into one batched matmul before the Unity search
(compiler/branch_stacking.py).

Run: python -m flexflow_tpu_torch.examples.split_test -b 8
"""

from __future__ import annotations

import numpy as np

from flexflow_tpu_torch.core import Activation, FFConfig, FFModel, SGDOptimizer
from flexflow_tpu_torch.examples import example_parser


def main(argv=None):
    p = example_parser()
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--hidden", type=int, default=32)
    args = p.parse_args(argv)
    cfg = FFConfig.from_args(args)

    m = FFModel(cfg, device=args.device)
    x = m.create_tensor([cfg.batch_size, args.hidden], name="x")
    t = m.dense(x, args.hidden, activation=Activation.RELU)
    a, b = m.split(t, [args.hidden // 2, args.hidden // 2], axis=1)
    a = m.dense(a, args.hidden)
    b = m.dense(b, args.hidden)
    logits = m.dense(m.add(a, b), 4)
    m.compile(SGDOptimizer(lr=cfg.learning_rate), "sparse_categorical_crossentropy",
              metrics=["accuracy"], logit_tensor=logits)

    n = args.steps * cfg.batch_size
    rs = np.random.RandomState(cfg.seed)
    xs = rs.randn(n, args.hidden).astype(np.float32)
    ys = rs.randint(0, 4, n)
    perf = m.fit(x=xs, y=ys, epochs=cfg.epochs)
    print(f"train accuracy = {perf.accuracy:.4f}")


if __name__ == "__main__":
    main()
