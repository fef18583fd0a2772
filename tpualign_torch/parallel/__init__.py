from tpualign_torch.parallel.embed import EmbedEngine, placeholder_embedding, truncate_to_bucket
from tpualign_torch.parallel.hnsw import HNSWIndex
from tpualign_torch.parallel.ivf import IVFIndex
from tpualign_torch.parallel.mesh import create_mesh, default_mesh
from tpualign_torch.parallel.retrieval import (
    RetrievalIndex, build_index, encode_keys, sharded_topk_search)

__all__ = ["EmbedEngine", "HNSWIndex", "IVFIndex", "RetrievalIndex", "build_index",
           "create_mesh", "default_mesh", "encode_keys", "placeholder_embedding",
           "sharded_topk_search", "truncate_to_bucket"]
