from repro_torch.elastic.trainer import (
    ElasticTrainer,
    LogicalDevice,
    ScaleEvent,
    TrainerBackend,
)

__all__ = ["ElasticTrainer", "LogicalDevice", "ScaleEvent", "TrainerBackend"]
