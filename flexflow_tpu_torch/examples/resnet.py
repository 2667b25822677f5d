"""ResNet-50 training example (port of examples/resnet.py; reference
examples/cpp/ResNet/resnet.cc): a 7x7 stem, a max pool, 16 bottleneck
blocks, a global average pool and a dense head, on seeded synthetic images.

Run: python -m flexflow_tpu_torch.examples.resnet -b 16 --steps 2
"""

from __future__ import annotations

import numpy as np

from flexflow_tpu_torch.core import FFConfig, FFModel, SGDOptimizer
from flexflow_tpu_torch.examples import example_parser


def bottleneck_block(m: FFModel, input, out_channels: int, stride: int, in_channels: int):
    """resnet.cc:39-59."""
    t = m.conv2d(input, out_channels, 1, 1, 1, 1, 0, 0)
    t = m.conv2d(t, out_channels, 3, 3, stride, stride, 1, 1)
    t = m.conv2d(t, 4 * out_channels, 1, 1, 1, 1, 0, 0)
    if stride > 1 or in_channels != out_channels * 4:
        input = m.conv2d(input, 4 * out_channels, 1, 1, stride, stride, 0, 0)
    return m.relu(m.add(input, t))


def main(argv=None):
    p = example_parser()
    p.add_argument("--image-size", type=int, default=229, help="input H/W (resnet.cc uses 229)")
    p.add_argument("--classes", type=int, default=10)
    p.add_argument("--steps", type=int, default=2)
    args = p.parse_args(argv)
    cfg = FFConfig.from_args(args)

    m = FFModel(cfg, device=args.device)
    x = m.create_tensor([cfg.batch_size, 3, args.image_size, args.image_size], name="image")
    t = m.conv2d(x, 64, 7, 7, 2, 2, 3, 3)
    t = m.pool2d(t, 3, 3, 2, 2, 1, 1)
    channels = 64 * 4  # after the first bottleneck's expansion
    t = bottleneck_block(m, t, 64, 1, 64)
    for _ in range(2):
        t = bottleneck_block(m, t, 64, 1, channels)
    for i in range(4):
        t = bottleneck_block(m, t, 128, 2 if i == 0 else 1, channels if i == 0 else 128 * 4)
    channels = 128 * 4
    for i in range(6):
        t = bottleneck_block(m, t, 256, 2 if i == 0 else 1, channels if i == 0 else 256 * 4)
    channels = 256 * 4
    for i in range(3):
        t = bottleneck_block(m, t, 512, 2 if i == 0 else 1, channels if i == 0 else 512 * 4)
    # the reference pools 7x7 at 229 input; generalized to the remaining extent
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
