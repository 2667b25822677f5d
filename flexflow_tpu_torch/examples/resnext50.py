"""ResNeXt-50 training example (port of examples/resnext50.py; reference
examples/cpp/resnext50/resnext.cc): grouped 3x3 convolutions in 16 blocks
of four stages, a global average pool and a dense head.

Run: python -m flexflow_tpu_torch.examples.resnext50 -b 16 --steps 2
"""

from __future__ import annotations

import numpy as np

from flexflow_tpu_torch.core import Activation, FFConfig, FFModel, SGDOptimizer
from flexflow_tpu_torch.examples import example_parser


def resnext_block(m, t, stride, out_channels, groups, in_channels, has_residual=False):
    """resnext.cc:12-32 (the residual path as in the torch model the reference
    cites; the reference gates it on has_residual)."""
    inp = t
    t = m.conv2d(t, out_channels, 1, 1, 1, 1, 0, 0, activation=Activation.RELU)
    t = m.conv2d(t, out_channels, 3, 3, stride, stride, 1, 1, activation=Activation.RELU,
                 groups=groups)
    t = m.conv2d(t, 2 * out_channels, 1, 1, 1, 1, 0, 0)
    if has_residual and (stride > 1 or in_channels != out_channels * 2):
        inp = m.conv2d(inp, 2 * out_channels, 1, 1, stride, stride, 0, 0,
                       activation=Activation.RELU)
        t = m.relu(m.add(inp, t))
    return t


def main(argv=None):
    p = example_parser()
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--classes", type=int, default=1000)
    p.add_argument("--groups", type=int, default=32)
    p.add_argument("--steps", type=int, default=2)
    args = p.parse_args(argv)
    cfg = FFConfig.from_args(args)

    m = FFModel(cfg, device=args.device)
    x = m.create_tensor([cfg.batch_size, 3, args.image_size, args.image_size], name="image")
    t = m.conv2d(x, 64, 7, 7, 2, 2, 3, 3, activation=Activation.RELU)
    t = m.pool2d(t, 3, 3, 2, 2, 1, 1)

    in_c = 64
    for stage, (reps, ch) in enumerate([(3, 128), (4, 256), (6, 512), (3, 1024)]):
        stride = 1 if stage == 0 else 2
        for _ in range(reps):
            t = resnext_block(m, t, stride, ch, args.groups, in_c)
            in_c = 2 * ch
            stride = 1

    t = m.relu(t)
    # the reference pools over the full remaining spatial extent
    sh, sw = t.dims[2], t.dims[3]
    t = m.pool2d(t, sh, sw, 1, 1, 0, 0, pool_type="avg")
    t = m.flat(t)
    logits = m.dense(t, args.classes)
    m.compile(SGDOptimizer(lr=cfg.learning_rate), "sparse_categorical_crossentropy",
              metrics=["accuracy"], logit_tensor=logits)

    n = args.steps * cfg.batch_size
    rs = np.random.RandomState(cfg.seed)
    xs = rs.randn(n, 3, args.image_size, args.image_size).astype(np.float32)
    ys = rs.randint(0, args.classes, n)
    perf = m.fit(x=xs, y=ys, epochs=cfg.epochs)
    print(f"train accuracy = {perf.accuracy:.4f}")


if __name__ == "__main__":
    main()
