"""``python -m paddle_tpu_torch.distributed.launch`` — the collective
launcher (``paddle_tpu/distributed/launch``; reference:
python/paddle/distributed/launch/)."""
from .main import launch, main  # noqa: F401
