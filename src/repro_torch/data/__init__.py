from repro_torch.data.synthetic import ShardedLoader, TokenStream, node_split

__all__ = ["ShardedLoader", "TokenStream", "node_split"]
