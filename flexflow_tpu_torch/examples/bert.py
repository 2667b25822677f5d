"""BERT training example over the model zoo (port of examples/bert.py;
reference lib/models/src/models/bert): the encoder stack and vocab head of
models.bert, SGD, seeded synthetic data. At the defaults (BERT-base: 12
layers, hidden 768, 12 heads, FFN 3072, seq 512) each head is 3072 / 12 =
256 wide. The default f32 compute takes the dense attention; the flash
kernels at head dim 256 take bf16 (FFModel.compile(compute_dtype=
torch.bfloat16)).

Run (smoke): python -m flexflow_tpu_torch.examples.bert -b 4 --seq 64 \\
             --hidden 64 --heads 4 --layers 2 --steps 1 --device cpu
"""

from __future__ import annotations

import numpy as np

from flexflow_tpu_torch.core import FFConfig, FFModel, SGDOptimizer
from flexflow_tpu_torch.examples import example_parser
from flexflow_tpu_torch.models.bert import BertConfig, build_bert


def main(argv=None):
    p = example_parser()
    p.add_argument("--seq", type=int, default=512)
    p.add_argument("--hidden", type=int, default=768)
    p.add_argument("--heads", type=int, default=12)
    p.add_argument("--layers", type=int, default=12)
    p.add_argument("--vocab", type=int, default=30522)
    p.add_argument("--steps", type=int, default=8)
    args = p.parse_args(argv)
    cfg = FFConfig.from_args(args)

    bcfg = BertConfig(
        vocab_size=args.vocab,
        hidden_size=args.hidden,
        num_encoder_layers=args.layers,
        num_heads=args.heads,
        dim_feedforward=4 * args.hidden,
        sequence_length=args.seq,
        batch_size=cfg.batch_size,
    )
    graph, out = build_bert(bcfg)
    m = FFModel.from_computation_graph(graph, out, cfg, device=args.device)
    m.compile(SGDOptimizer(lr=cfg.learning_rate), "sparse_categorical_crossentropy",
              metrics=["accuracy"])

    n = args.steps * cfg.batch_size
    rs = np.random.RandomState(cfg.seed)
    xs = rs.randn(n, args.seq, args.hidden).astype(np.float32)
    ys = rs.randint(0, args.vocab, (n, args.seq))
    perf = m.fit(x=xs, y=ys, epochs=cfg.epochs)
    print(f"train accuracy = {perf.accuracy:.4f}")


if __name__ == "__main__":
    main()
