"""Builders for ``python -m paddle_tpu_torch.tools.graph_lint``: each takes
the device to build on and returns ``(layer, input_specs)``.

    python -m paddle_tpu_torch.tools.graph_lint paddle_tpu_torch/examples/lint_models.py
    python -m paddle_tpu_torch.tools.graph_lint paddle_tpu_torch/examples/lint_models.py \\
        --builder build_resnet
"""
from __future__ import annotations


def build_model(device="cpu", layers=2, hidden=64, seq=32):
    """A GPT at the given depth and width (GPT-2 345M: 24, 1024, 1024)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining

    pt.seed(0)
    cfg = GPTConfig(vocab_size=1024, hidden_size=hidden, num_layers=layers,
                    num_heads=max(1, hidden // 64), max_seq_len=seq, dropout=0.0,
                    attn_dropout=0.0)
    return GPTForPretraining(cfg, device=device), [((2, seq), "int64")]


def build_resnet(device="cpu"):
    """ResNet-18 over a small image batch."""
    import paddle_tpu_torch as pt

    pt.seed(0)
    model = pt.vision.models.resnet18(num_classes=10).to(device)
    return model, [((2, 3, 32, 32), "float32")]
