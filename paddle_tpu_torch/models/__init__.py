from .bert import (  # noqa: F401
    BertConfig,
    BertEmbeddings,
    BertEncoderLayer,
    BertForPretraining,
    BertModel,
    BertPretrainingCriterion,
)
from .gpt import (  # noqa: F401
    GPTConfig,
    GPTForPretraining,
    GPTModel,
    GPTPretrainingCriterion,
    gpt2_345m,
    gpt2_medium,
    gpt2_small,
)
