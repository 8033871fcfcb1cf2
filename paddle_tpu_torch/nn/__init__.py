"""``paddle.nn`` for the port: layers are ``nn.Layer``s, ``torch.nn.Module``s
with Paddle's state methods (``paddle_tpu/nn/__init__.py``), the recurrent
layers of ``nn/layer/rnn.py`` included. ``nn.Parameter`` is the port's
``core.tensor.Parameter``, a ``torch.nn.Parameter`` whose grad the
whole-step capture watches.

Not ported yet (ROADMAP, open items, queue 1 item 14): ``nn.quant``, whose
working layers come from ``quantization/``.
"""

from . import clip, functional, initializer, layer_base, utils  # noqa: F401
from .clip import (  # noqa: F401
    ClipGradByGlobalNorm,
    ClipGradByNorm,
    ClipGradByValue,
    GradientClipByGlobalNorm,
    GradientClipByNorm,
    GradientClipByValue,
)
from .layer.activation import (  # noqa: F401
    CELU, ELU, GELU, GLU, Hardshrink, Hardsigmoid, Hardswish, Hardtanh, LeakyReLU, LogSigmoid,
    LogSoftmax, Maxout, Mish, PReLU, ReLU, ReLU6, SELU, Sigmoid, Silu, Softmax, Softplus,
    Softshrink, Softsign, Swish, Tanh, Tanhshrink, ThresholdedReLU,
)
from .layer.common import (  # noqa: F401
    AlphaDropout, Bilinear, CosineSimilarity, Dropout, Dropout2D, Dropout3D, Embedding,
    Flatten, Fold, Identity, LayerDict, LayerList, Linear, Pad1D, Pad2D, Pad3D,
    PairwiseDistance, ParameterList, PixelShuffle, PixelUnshuffle, Sequential, Unfold,
    Upsample, UpsamplingBilinear2D, UpsamplingNearest2D, ZeroPad2D,
)
from .layer.conv import (  # noqa: F401
    Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D, Conv3DTranspose,
)
from .layer.loss import (  # noqa: F401
    BCELoss, BCEWithLogitsLoss, CrossEntropyLoss, CTCLoss, HingeEmbeddingLoss, HSigmoidLoss,
    KLDivLoss, L1Loss, MarginRankingLoss, MSELoss, NLLLoss, SmoothL1Loss,
)
from .layer.norm import (  # noqa: F401
    BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, GroupNorm, InstanceNorm1D,
    InstanceNorm2D, InstanceNorm3D, LayerNorm, LocalResponseNorm, SpectralNorm, SyncBatchNorm,
)
from .layer.pooling import (  # noqa: F401
    AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D, AdaptiveMaxPool1D,
    AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool1D, AvgPool2D, AvgPool3D, MaxPool1D,
    MaxPool2D, MaxPool3D, MaxUnPool1D, MaxUnPool2D, MaxUnPool3D,
)
from .layer.transformer import (  # noqa: F401
    MultiHeadAttention, Transformer, TransformerDecoder, TransformerDecoderLayer,
    TransformerEncoder, TransformerEncoderLayer,
)
from .layer_base import Layer  # noqa: F401
from .param_attr import ParamAttr  # noqa: F401
from .utils_fns import clip_grad_norm_, clip_grad_value_  # noqa: F401

from .layer.rnn import (  # noqa: F401,E402
    GRU, LSTM, RNN, BeamSearchDecoder, BiRNN, GRUCell, LSTMCell, RNNCellBase, SimpleRNN,
    SimpleRNNCell, dynamic_decode,
)
from ..core.tensor import Parameter  # noqa: F401,E402
