"""Loss layers (``paddle_tpu/nn/layer/loss.py``): each holds its arguments
and calls its ``nn.functional`` function; ``HSigmoidLoss`` holds the
tree's weights."""
from __future__ import annotations

from .. import functional as F
from ..layer_base import Layer
from .common import functional_layer, param_of


def _loss(cls_name, fn_name, n_inputs, arg_names, defaults):
    return functional_layer(__name__, cls_name, fn_name, arg_names, defaults, n_inputs)


CrossEntropyLoss = _loss(
    "CrossEntropyLoss", "cross_entropy", 2,
    ("weight", "ignore_index", "reduction", "soft_label", "axis", "use_softmax",
     "label_smoothing"),
    {"weight": None, "ignore_index": -100, "reduction": "mean", "soft_label": False,
     "axis": -1, "use_softmax": True, "label_smoothing": 0.0})
MSELoss = _loss("MSELoss", "mse_loss", 2, ("reduction",), {"reduction": "mean"})
L1Loss = _loss("L1Loss", "l1_loss", 2, ("reduction",), {"reduction": "mean"})
SmoothL1Loss = _loss("SmoothL1Loss", "smooth_l1_loss", 2, ("reduction", "delta"),
                     {"reduction": "mean", "delta": 1.0})
BCELoss = _loss("BCELoss", "binary_cross_entropy", 2, ("weight", "reduction"),
                {"weight": None, "reduction": "mean"})
BCEWithLogitsLoss = _loss("BCEWithLogitsLoss", "binary_cross_entropy_with_logits", 2,
                          ("weight", "reduction", "pos_weight"),
                          {"weight": None, "reduction": "mean", "pos_weight": None})
NLLLoss = _loss("NLLLoss", "nll_loss", 2, ("weight", "ignore_index", "reduction"),
                {"weight": None, "ignore_index": -100, "reduction": "mean"})
KLDivLoss = _loss("KLDivLoss", "kl_div", 2, ("reduction",), {"reduction": "mean"})
MarginRankingLoss = _loss("MarginRankingLoss", "margin_ranking_loss", 3,
                          ("margin", "reduction"), {"margin": 0.0, "reduction": "mean"})
HingeEmbeddingLoss = _loss("HingeEmbeddingLoss", "hinge_embedding_loss", 2,
                           ("margin", "reduction"), {"margin": 1.0, "reduction": "mean"})


class CTCLoss(Layer):
    """CTC over ``[T, B, C]`` logits (``F.ctc_loss``)."""

    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank = blank
        self.reduction = reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths, norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths, self.blank,
                          self.reduction, norm_by_times)


class HSigmoidLoss(Layer):
    """Hierarchical sigmoid over ``num_classes`` leaves: a weight row and a
    bias per inner node (``num_classes - 1``)."""

    def __init__(self, feature_size, num_classes, weight_attr=None, bias_attr=None,
                 is_custom=False, is_sparse=False, name=None, device=None):
        super().__init__()
        if num_classes < 2:
            raise ValueError("num_classes must be >= 2")
        self.num_classes = num_classes
        self.is_custom = is_custom
        self.weight = param_of([num_classes - 1, feature_size], weight_attr, None, device)
        self.bias = (None if bias_attr is False
                     else param_of([num_classes - 1], bias_attr, None, device, is_bias=True))

    def forward(self, input, label, path_table=None, path_code=None):
        return F.hsigmoid_loss(input, label, self.num_classes, self.weight, self.bias,
                               path_table, path_code)
