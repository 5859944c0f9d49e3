from repro_torch.elastic.trainer import ElasticTrainer, LogicalDevice, ScaleEvent

__all__ = ["ElasticTrainer", "LogicalDevice", "ScaleEvent"]
