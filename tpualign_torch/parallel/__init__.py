from tpualign_torch.parallel.embed import EmbedEngine, placeholder_embedding, truncate_to_bucket
from tpualign_torch.parallel.hnsw import HNSWIndex
from tpualign_torch.parallel.ivf import IVFIndex
from tpualign_torch.parallel.mesh import create_mesh, default_mesh
from tpualign_torch.parallel.retrieval import (
    RetrievalIndex, build_index, encode_keys, sharded_topk_search)
from tpualign_torch.parallel.sharding import clip_param_specs, shard_params

__all__ = ["EmbedEngine", "HNSWIndex", "IVFIndex", "RetrievalIndex", "build_index",
           "clip_param_specs", "create_mesh", "default_mesh", "encode_keys",
           "placeholder_embedding", "shard_params", "sharded_topk_search",
           "truncate_to_bucket"]
