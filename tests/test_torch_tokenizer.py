"""tpualign_torch's standard-library tokenizer against the JAX package's
(which splits with the ``regex`` package): the same words and the same
token ids."""

import unicodedata

import numpy as np
import pytest

from tpualign.tokenizer import ClipTokenizer as JaxTokenizer
from tpualign_torch.tokenizer import ClipTokenizer, split_words

pytestmark = pytest.mark.fast

TEXTS = [
    "Remove the oil filter and replace the O-ring.",
    "De oliefilter vervangen: draai de bouten los (zie fig. 3).",
    "Vóór gebruik: controleer het peil — ĳzeren onderdelen, één keer per week!",
    "Torque 25 Nm, 3.14159 rad, 1/2 inch, 10,000 rpm",
    "Area in m² and volume in m³; ½ or ¼ turn; x₂ H₂O; ①②",
    "!!! ... ??? --->> *** ¡¿ «quoted» “curly”",
    "don't it's we're they've I'm we'll he'd DON'T It'S",
    "'s 't 're 've 'm 'll 'd ''s x''t",
    "<|startoftext|>a<|endoftext|> <|ENDOFTEXT|> <|ſtartoftext|>",
    "café naïve Ærø Straße İstanbul ǅemal ﬁnal",
    "tabs\tand\nnewlines\r\n  and   spaces nbsp em",
    "separators\x1cfile\x1dgroup\x1erecord\x1funit",
    "ypogegrammeni ͅ alone, ᾳ composed, 'ſ long s",
    "&amp; &lt;tag&gt; &amp;amp; entities",
    "数字１２３ アイウ 한국어 العربية १२३ ٣٤",
    "",
    "   ",
    "word " * 60,
]


@pytest.fixture(scope="module")
def tokenizers():
    return ClipTokenizer(), JaxTokenizer()


@pytest.mark.parametrize("text", TEXTS)
def test_split_matches_regex(tokenizers, text):
    _, jax_tok = tokenizers
    from tpualign.tokenizer.bpe import _basic_clean, _whitespace_clean

    cleaned = _whitespace_clean(_basic_clean(text)).lower()
    assert split_words(cleaned) == jax_tok.pat.findall(cleaned)


def test_split_is_case_insensitive_like_regex(tokenizers):
    _, jax_tok = tokenizers
    text = "IT'S We'LL <|EndOfText|> O'S x'Kelvin"
    assert split_words(text) == jax_tok.pat.findall(text)


def test_ids_match_jax(tokenizers):
    tok, jax_tok = tokenizers
    np.testing.assert_array_equal(tok(TEXTS), jax_tok(TEXTS))
    assert (tok.sot_id, tok.eot_id, tok.vocab_size) == (
        jax_tok.sot_id, jax_tok.eot_id, jax_tok.vocab_size)
    assert tok(TEXTS[-1])[0, -1] == tok.eot_id       # truncation forces EOT
    assert tok.decode(tok.encode("hello world")) == jax_tok.decode(
        jax_tok.encode("hello world"))


def test_every_bmp_character_splits_like_regex(tokenizers):
    """Each assigned BMP character, alone and between letters, digits and
    spaces, splits as the regex package splits it."""
    _, jax_tok = tokenizers
    chars = [chr(cp) for cp in range(0x20, 0x10000)
             if not 0xD800 <= cp <= 0xDFFF and unicodedata.category(chr(cp)) != "Cn"]
    for i in range(0, len(chars), 64):
        text = " ".join(f"a{c}b1{c}{c}2 {c}" for c in chars[i:i + 64])
        assert split_words(text) == jax_tok.pat.findall(text), chars[i:i + 64]
