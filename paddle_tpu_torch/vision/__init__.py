"""``paddle.vision`` for the port: the model zoo of
``paddle_tpu/vision/models.py`` and its top-level aliases. Datasets,
transforms, ``vision.ops`` and the rest of the zoo (``models_extra``) are
ROADMAP queue 1 item 14."""
from . import models  # noqa: F401
from .models import LeNet, ResNet, resnet18, resnet34, resnet50, resnet101, vgg16  # noqa: F401
