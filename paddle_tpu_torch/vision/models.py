"""The vision model zoo of ``paddle_tpu/vision/models.py``: LeNet, ResNet
(with its wide and ResNeXt forms), VGG, MobileNetV2 and AlexNet, as
compositions of the port's ``nn`` layers. State dict names and layouts
are the JAX models', so ``convert.state_dict_from_numpy`` carries weights
and batch-norm statistics across. Parameters are made on the current
device (``paddle.set_device``)."""
from __future__ import annotations

from .. import nn


class LeNet(nn.Layer):
    def __init__(self, num_classes=10):
        super().__init__()
        self.num_classes = num_classes
        self.features = nn.Sequential(
            nn.Conv2D(1, 6, 3, stride=1, padding=1), nn.ReLU(), nn.MaxPool2D(2, 2),
            nn.Conv2D(6, 16, 5, stride=1, padding=0), nn.ReLU(), nn.MaxPool2D(2, 2),
        )
        if num_classes > 0:
            self.fc = nn.Sequential(nn.Linear(400, 120), nn.Linear(120, 84),
                                    nn.Linear(84, num_classes))

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x


class BasicBlock(nn.Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1, base_width=64,
                 dilation=1, norm_layer=None):
        super().__init__()
        norm_layer = norm_layer or nn.BatchNorm2D
        self.conv1 = nn.Conv2D(inplanes, planes, 3, stride=stride, padding=1, bias_attr=False)
        self.bn1 = norm_layer(planes)
        self.relu = nn.ReLU()
        self.conv2 = nn.Conv2D(planes, planes, 3, padding=1, bias_attr=False)
        self.bn2 = norm_layer(planes)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Layer):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1, base_width=64,
                 dilation=1, norm_layer=None):
        super().__init__()
        norm_layer = norm_layer or nn.BatchNorm2D
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = nn.Conv2D(inplanes, width, 1, bias_attr=False)
        self.bn1 = norm_layer(width)
        self.conv2 = nn.Conv2D(width, width, 3, padding=1, stride=stride, groups=groups,
                               dilation=dilation, bias_attr=False)
        self.bn2 = norm_layer(width)
        self.conv3 = nn.Conv2D(width, planes * self.expansion, 1, bias_attr=False)
        self.bn3 = norm_layer(planes * self.expansion)
        self.relu = nn.ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(nn.Layer):
    _LAYERS = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3], 101: [3, 4, 23, 3],
               152: [3, 8, 36, 3]}

    def __init__(self, block, depth=50, width=64, num_classes=1000, with_pool=True, groups=1):
        super().__init__()
        layers = self._LAYERS[depth]
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self._norm_layer = nn.BatchNorm2D
        self.inplanes = 64
        self.dilation = 1
        self.conv1 = nn.Conv2D(3, self.inplanes, 7, stride=2, padding=3, bias_attr=False)
        self.bn1 = self._norm_layer(self.inplanes)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2D(3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = nn.Linear(512 * block.expansion, num_classes)

    def _make_layer(self, block, planes, blocks, stride=1):
        norm_layer = self._norm_layer
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2D(self.inplanes, planes * block.expansion, 1, stride=stride,
                          bias_attr=False),
                norm_layer(planes * block.expansion),
            )
        layers = [block(self.inplanes, planes, stride, downsample, self.groups,
                        self.base_width, norm_layer=norm_layer)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width, norm_layer=norm_layer))
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x


def _resnet(depth, block, pretrained=False, **kwargs):
    return ResNet(block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(18, BasicBlock, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(34, BasicBlock, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(50, BottleneckBlock, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(101, BottleneckBlock, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(152, BottleneckBlock, pretrained, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    return _resnet(50, BottleneckBlock, pretrained, **{**kwargs, "width": 128})


def wide_resnet101_2(pretrained=False, **kwargs):
    return _resnet(101, BottleneckBlock, pretrained, **{**kwargs, "width": 128})


def resnext50_32x4d(pretrained=False, **kwargs):
    return _resnet(50, BottleneckBlock, pretrained, **{**kwargs, "groups": 32, "width": 4})


class ResNeXt(ResNet):
    """A grouped-convolution ResNet: ``cardinality`` groups of ``width``."""

    def __init__(self, depth=50, cardinality=32, width=4, num_classes=1000, with_pool=True):
        super().__init__(BottleneckBlock, depth, width=width, num_classes=num_classes,
                         with_pool=with_pool, groups=cardinality)


def resnext50_64x4d(pretrained=False, **kwargs):
    return ResNeXt(50, cardinality=64, width=4, **kwargs)


def resnext101_32x4d(pretrained=False, **kwargs):
    return ResNeXt(101, cardinality=32, width=4, **kwargs)


def resnext101_64x4d(pretrained=False, **kwargs):
    return ResNeXt(101, cardinality=64, width=4, **kwargs)


def resnext152_32x4d(pretrained=False, **kwargs):
    return ResNeXt(152, cardinality=32, width=4, **kwargs)


def resnext152_64x4d(pretrained=False, **kwargs):
    return ResNeXt(152, cardinality=64, width=4, **kwargs)


class VGG(nn.Layer):
    def __init__(self, features, num_classes=1000, with_pool=True):
        super().__init__()
        self.features = features
        self.num_classes = num_classes
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(512 * 7 * 7, 4096), nn.ReLU(), nn.Dropout(),
                nn.Linear(4096, 4096), nn.ReLU(), nn.Dropout(),
                nn.Linear(4096, num_classes),
            )

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def _make_vgg_layers(cfg, batch_norm=False):
    layers = []
    in_c = 3
    for v in cfg:
        if v == "M":
            layers.append(nn.MaxPool2D(2, 2))
        else:
            layers.append(nn.Conv2D(in_c, v, 3, padding=1))
            if batch_norm:
                layers.append(nn.BatchNorm2D(v))
            layers.append(nn.ReLU())
            in_c = v
    return nn.Sequential(*layers)


_VGG_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
          512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M",
          512, 512, 512, 512, "M"],
}


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return VGG(_make_vgg_layers(_VGG_CFGS["A"], batch_norm), **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return VGG(_make_vgg_layers(_VGG_CFGS["B"], batch_norm), **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return VGG(_make_vgg_layers(_VGG_CFGS["D"], batch_norm), **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return VGG(_make_vgg_layers(_VGG_CFGS["E"], batch_norm), **kwargs)


class _InvertedResidual(nn.Layer):
    def __init__(self, inp, oup, stride, expand_ratio):
        super().__init__()
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers += [nn.Conv2D(inp, hidden, 1, bias_attr=False), nn.BatchNorm2D(hidden),
                       nn.ReLU6()]
        layers += [
            nn.Conv2D(hidden, hidden, 3, stride=stride, padding=1, groups=hidden,
                      bias_attr=False),
            nn.BatchNorm2D(hidden), nn.ReLU6(),
            nn.Conv2D(hidden, oup, 1, bias_attr=False), nn.BatchNorm2D(oup),
        ]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool

        def c(ch):
            return max(8, int(ch * scale + 4) // 8 * 8)

        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2), (6, 96, 3, 1),
               (6, 160, 3, 2), (6, 320, 1, 1)]  # expansion t, channels c, repeats n, stride s
        layers = [nn.Conv2D(3, c(32), 3, stride=2, padding=1, bias_attr=False),
                  nn.BatchNorm2D(c(32)), nn.ReLU6()]
        in_c = c(32)
        for t, ch, n, s in cfg:
            for i in range(n):
                layers.append(_InvertedResidual(in_c, c(ch), s if i == 0 else 1, t))
                in_c = c(ch)
        self.last_c = c(1280)
        layers += [nn.Conv2D(in_c, self.last_c, 1, bias_attr=False),
                   nn.BatchNorm2D(self.last_c), nn.ReLU6()]
        self.features = nn.Sequential(*layers)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.classifier = nn.Sequential(nn.Dropout(0.2), nn.Linear(self.last_c, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV2(scale=scale, **kwargs)


class AlexNet(nn.Layer):
    def __init__(self, num_classes=1000):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2D(3, 64, 11, stride=4, padding=2), nn.ReLU(), nn.MaxPool2D(3, 2),
            nn.Conv2D(64, 192, 5, padding=2), nn.ReLU(), nn.MaxPool2D(3, 2),
            nn.Conv2D(192, 384, 3, padding=1), nn.ReLU(),
            nn.Conv2D(384, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2D(256, 256, 3, padding=1), nn.ReLU(), nn.MaxPool2D(3, 2),
        )
        self.avgpool = nn.AdaptiveAvgPool2D((6, 6))
        self.classifier = nn.Sequential(
            nn.Dropout(), nn.Linear(256 * 6 * 6, 4096), nn.ReLU(),
            nn.Dropout(), nn.Linear(4096, 4096), nn.ReLU(),
            nn.Linear(4096, num_classes),
        )

    def forward(self, x):
        x = self.avgpool(self.features(x))
        return self.classifier(x.flatten(1))


def alexnet(pretrained=False, **kwargs):
    return AlexNet(**kwargs)
