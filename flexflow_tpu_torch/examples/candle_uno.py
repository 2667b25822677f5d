"""CANDLE-UNO training example over the model zoo (port of
examples/candle_uno.py; reference examples/cpp/candle_uno): seven input
features, the dense feature towers and trunk of models.candle_uno, a
1-unit regressor, mean squared error.

Run (smoke): python -m flexflow_tpu_torch.examples.candle_uno -b 4 --steps 1 --dense-size 32
"""

from __future__ import annotations

import numpy as np

from flexflow_tpu_torch.core import FFConfig, FFModel, SGDOptimizer
from flexflow_tpu_torch.examples import example_parser
from flexflow_tpu_torch.models.candle_uno import (
    CandleUnoConfig,
    build_candle_uno,
    get_default_candle_uno_config,
)


def main(argv=None):
    p = example_parser()
    p.add_argument("--steps", type=int, default=1)
    p.add_argument("--dense-size", type=int, default=None,
                   help="override tower/trunk widths (default 4192 as in the reference; use a "
                        "small value for smoke runs)")
    args = p.parse_args(argv)
    cfg = FFConfig.from_args(args)

    base = get_default_candle_uno_config()
    ucfg = CandleUnoConfig(
        batch_size=cfg.batch_size,
        dense_layers=(args.dense_size,) * 4 if args.dense_size else base.dense_layers,
        dense_feature_layers=(
            (args.dense_size,) * 8 if args.dense_size else base.dense_feature_layers),
        feature_shapes=base.feature_shapes,
        input_features=base.input_features,
        dropout=base.dropout,
        residual=base.residual,
    )
    graph, out = build_candle_uno(ucfg)
    # the adopted graph's output is the model's last output, which compile takes
    m = FFModel.from_computation_graph(graph, out, cfg, device=args.device)
    m.compile(SGDOptimizer(lr=cfg.learning_rate), "mean_squared_error",
              metrics=["mean_squared_error"])

    n = args.steps * cfg.batch_size
    rs = np.random.RandomState(cfg.seed)
    shapes = dict(ucfg.feature_shapes)
    xs = {name: rs.randn(n, shapes[kind]).astype(np.float32)
          for name, kind in ucfg.input_features}
    ys = rs.rand(n, 1).astype(np.float32)
    perf = m.fit(x=xs, y=ys, epochs=cfg.epochs)
    print(f"train mse = {perf.mse_loss / max(perf.train_all, 1):.6f}")


if __name__ == "__main__":
    main()
