"""The paper's convnet workload family (ResNet-18/34/50 on ImageNet-1K) at
reduced CIFAR scale. An LM-shaped ModelConfig stands in the registry, as
in the reference; the conv model is `models.resnet` with `resnet_config`."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.resnet import ResNetConfig


def full() -> ModelConfig:
    # The reference's registry placeholder; conv runs use resnet_config().
    return ModelConfig(arch="paper-resnet", family="dense", n_layers=2,
                       d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
                       vocab_size=512)


def smoke() -> ModelConfig:
    return full()


def resnet_config(**kw) -> ResNetConfig:
    """ResNetConfig(): depth (2, 2, 2), widths (32, 64, 128), 10 classes."""
    return ResNetConfig(**kw)
