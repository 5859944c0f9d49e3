from repro_torch.data.synthetic import (
    ShardedLoader,
    TokenStream,
    make_train_batch,
    node_split,
)

__all__ = ["ShardedLoader", "TokenStream", "make_train_batch", "node_split"]
