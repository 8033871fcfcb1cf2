"""Train a small GPT on synthetic data: one process, or any hybrid under the
launcher (the JAX package's ``examples/train_gpt.py``, over the port).

    python -m paddle_tpu_torch.examples.train_gpt                 # one card
    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 8 \\
        paddle_tpu_torch/examples/train_gpt.py --dp 2 --mp 2 --sharding 2
    PADDLE_DISTRI_BACKEND=gloo python -m paddle_tpu_torch.distributed.launch \\
        --devices 0,0,0,0 paddle_tpu_torch/examples/train_gpt.py --dp 2 --mp 2

Every rank is given the same global batches and prints the loss and the
generated ids; ``--device cpu`` runs on the CPU (over gloo under the
launcher).
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import paddle_tpu_torch as paddle  # noqa: E402
from paddle_tpu_torch.distributed import fleet  # noqa: E402
from paddle_tpu_torch.models.gpt import (  # noqa: E402
    GPTConfig,
    GPTForPretraining,
    GPTPretrainingCriterion,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--mp", type=int, default=1)
    ap.add_argument("--sharding", type=int, default=1)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default=None, help="cpu, or the card (the default)")
    args = ap.parse_args()
    if args.device:
        paddle.set_device(args.device)

    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": args.dp, "mp_degree": args.mp,
                               "sharding_degree": args.sharding}
    if args.sharding > 1:
        strategy.sharding = True
        strategy.sharding_configs = {"stage": 2}
    fleet.init(is_collective=True, strategy=strategy)

    paddle.seed(0)
    cfg = GPTConfig(vocab_size=1024, hidden_size=256, num_layers=4, num_heads=8,
                    max_seq_len=args.seq, dropout=0.0, attn_dropout=0.0)
    model = fleet.distributed_model(GPTForPretraining(cfg))
    criterion = GPTPretrainingCriterion(cfg)
    opt = paddle.optimizer.AdamW(learning_rate=3e-4, parameters=model.parameters())
    step = fleet.distributed_train_step(model, criterion, opt)

    rng = np.random.default_rng(0)
    for it in range(args.steps):
        ids = paddle.to_tensor(rng.integers(0, cfg.vocab_size, (args.batch, args.seq + 1)))
        loss = step(ids[:, :-1], ids[:, 1:])
        if it % 5 == 0:
            print(f"step {it}: loss {float(loss):.4f}", flush=True)
    out = model.generate(ids.numpy()[:1, :8], max_new_tokens=16)
    print("generated ids:", out.cpu().numpy()[0].tolist(), flush=True)


if __name__ == "__main__":
    main()
