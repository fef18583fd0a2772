from tpualign_torch.tokenizer.bpe import ClipTokenizer, bytes_to_unicode, split_words, tokenize

__all__ = ["ClipTokenizer", "bytes_to_unicode", "split_words", "tokenize"]
