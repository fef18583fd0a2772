from tpualign_torch.parallel.embed import EmbedEngine, placeholder_embedding, truncate_to_bucket
from tpualign_torch.parallel.retrieval import RetrievalIndex, encode_keys

__all__ = ["EmbedEngine", "RetrievalIndex", "encode_keys", "placeholder_embedding",
           "truncate_to_bucket"]
