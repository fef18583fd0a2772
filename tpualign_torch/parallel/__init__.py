from tpualign_torch.parallel.embed import EmbedEngine, placeholder_embedding, truncate_to_bucket
from tpualign_torch.parallel.hnsw import HNSWIndex
from tpualign_torch.parallel.retrieval import RetrievalIndex, build_index, encode_keys

__all__ = ["EmbedEngine", "HNSWIndex", "RetrievalIndex", "build_index", "encode_keys",
           "placeholder_embedding", "truncate_to_bucket"]
