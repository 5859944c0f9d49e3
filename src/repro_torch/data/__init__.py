from repro_torch.data.synthetic import (
    ImageStream,
    ShardedLoader,
    TokenStream,
    make_train_batch,
    node_split,
)

__all__ = ["ImageStream", "ShardedLoader", "TokenStream", "make_train_batch",
           "node_split"]
