"""Port parity: the tokenizers (models/tokenizer.py). The port keeps its own
copy of the reference's plain-Python tokenizers; encode ids and decoded
text must equal the reference's on the reference test's SentencePiece and
BPE vocabularies, on a 32000-token synthetic SentencePiece vocabulary (the
smoke's), on a fixed list of edge cases and on 200 seeded random strings,
and `from_gguf` must read them back from the port's own GGUF writer."""
import numpy as np
import pytest

import chip_smoke
from ggml_gfx906_tpu.gguf import GGUFReader as JReader
from ggml_gfx906_tpu.models import tokenizer as jtok
from ggml_gfx906_tpu_torch.gguf import GGUFReader, GGUFWriter
from ggml_gfx906_tpu_torch.models import tokenizer as ttok

from _torch_port import one_torch_thread  # noqa: F401

FIXED = ["", " ", "   ", " leading", "trailing  ", "a  b", "the ab", "abc", "zap!",
         "héllo", "🎉 abc", "日本語のテキスト", "tab\tand\nnewline", "\x00\x01", "ab" * 40,
         "▁ already marked", "<s> not a control", "édition spéciale ½ ∑"]
POOL = list("abcdefghst ▁.,!?'-0123456789\t\n") + ["é", "ß", "中", "🎉", "ё", "½"]


def _random_strings(n=200, seed=0):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(POOL, int(rng.integers(0, 40)))) for _ in range(n)]


def _spm_vocab():
    """The reference test's vocabulary: 0=<unk>, 1=<s>, 2=</s>, the 256
    byte tokens, then scored pieces."""
    tokens = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    types = [jtok.TT_UNKNOWN, jtok.TT_CONTROL, jtok.TT_CONTROL] + [jtok.TT_BYTE] * 256
    pieces = {"▁": -2.0, "a": -1.0, "b": -1.0, "c": -1.0, "d": -1.0, "ab": -3.0,
              "bc": -2.5, "abc": -4.0, "▁ab": -3.5, "▁the": -5.0, "t": -1.2, "h": -1.3,
              "e": -1.1, "th": -6.0, "he": -7.0, "▁t": -8.0, "▁th": -6.5}
    scores = [0.0] * len(tokens) + list(pieces.values())
    return tokens + list(pieces), scores, types + [jtok.TT_NORMAL] * len(pieces)


def _bpe_vocab():
    enc = jtok.bytes_to_unicode()
    vocab = [enc[b] for b in range(256)] + ["he", "ll", "hell", "llo", "hello", "Ġw", "Ġwo",
                                            "Ġt", "Ġth", "Ġthe", "ab", "Ġab"]
    merges = ["h e", "l l", "he ll", "ll o", "hell o", "Ġ w", "Ġw o", "Ġ t", "Ġt h",
              "Ġth e", "a b", "Ġ ab"]
    return vocab, merges


def _pairs():
    """(name, port tokenizer, reference tokenizer) built from the same lists."""
    spm = _spm_vocab()
    big = [list(x) for x in chip_smoke.spm_vocab(32000)]
    no_bytes = (["<unk>", "a", "b", "ab", "▁"], [0.0, -1.0, -1.0, -0.5, -2.0],
                [jtok.TT_UNKNOWN] + [jtok.TT_NORMAL] * 4)
    vocab, merges = _bpe_vocab()
    return [
        ("spm", ttok.SPMTokenizer(*spm), jtok.SPMTokenizer(*spm)),
        ("spm_no_prefix_no_bos", ttok.SPMTokenizer(*spm, add_space_prefix=False, add_bos=False),
         jtok.SPMTokenizer(*spm, add_space_prefix=False, add_bos=False)),
        ("spm_32000", ttok.SPMTokenizer(*big), jtok.SPMTokenizer(*big)),
        ("spm_unknown", ttok.SPMTokenizer(*no_bytes), jtok.SPMTokenizer(*no_bytes)),
        ("bpe", ttok.BPETokenizer(vocab, merges), jtok.BPETokenizer(vocab, merges)),
        ("bpe_greedy", ttok.BPETokenizer(vocab), jtok.BPETokenizer(vocab)),
    ]


PAIRS = {name: (t, j) for name, t, j in _pairs()}


@pytest.mark.parametrize("name", list(PAIRS))
def test_encode_decode_equal_reference(name):
    t, j = PAIRS[name]
    texts = FIXED + _random_strings(seed=len(name))
    if name == "spm_32000":
        texts.append(chip_smoke.synthetic_text(300, seed=3))
    for text in texts:
        ids = t.encode(text)
        assert ids == j.encode(text), text
        assert t.decode(ids) == j.decode(ids), text
    assert t.n_vocab == j.n_vocab


@pytest.mark.parametrize("name", ["spm", "spm_32000", "spm_unknown"])
def test_spm_decode_of_any_ids_and_bos_switch(name):
    """Decode strips control and unused ids and resolves byte tokens as the
    reference does, on seeded random id lists (control ids included)."""
    t, j = PAIRS[name]
    control = [i for i, tt in enumerate(t.token_types) if tt == ttok.TT_CONTROL]
    ids = control + t.encode("ab") + control
    assert t.decode(ids) == j.decode(ids) == j.decode(t.encode("ab"))
    rng = np.random.default_rng(1)
    for _ in range(50):
        ids = [int(i) for i in rng.integers(0, t.n_vocab, int(rng.integers(0, 30)))]
        assert t.decode(ids) == j.decode(ids), ids
    for text in ("the ab", "", "zap"):
        for bos in (True, False, None):
            assert t.encode(text, add_bos=bos) == j.encode(text, add_bos=bos)


def test_spm_tie_break_leftmost_and_byte_fallback():
    tokens = ["<unk>", "xy", "yz", "x", "y", "z"]
    types = [jtok.TT_UNKNOWN] + [jtok.TT_NORMAL] * 5
    scores = [0.0, -1.0, -1.0, -0.1, -0.1, -0.1]
    tok = ttok.SPMTokenizer(tokens, scores, types, add_space_prefix=False, add_bos=False)
    assert [tok.tokens[i] for i in tok.encode("xyz")] == ["xy", "z"]
    t = PAIRS["spm"][0]
    ids = t.encode("z", add_bos=False)
    assert [t.token_types[i] for i in ids[-1:]] == [ttok.TT_BYTE]
    assert t.decode(t.encode("🎉 abc")) == "🎉 abc"


def _write(path, kv: dict):
    w = GGUFWriter()
    for key, val in kv.items():
        w.set(key, val)
    w.add_array_tensor("dummy", np.zeros((4,), np.float32))
    w.write(path)


@pytest.mark.parametrize("which", ["spm", "spm_32000", "bpe", "bpe_greedy"])
def test_from_gguf_through_the_ports_writer_and_reader(tmp_path, which):
    """The tokenizer metadata written by the port's writer (scores as
    floats, token types as ints) reads back through the port's reader into
    the tokenizer the reference reads from the same file."""
    path = tmp_path / f"{which}.gguf"
    if which.startswith("spm"):
        tokens, scores, types = (_spm_vocab() if which == "spm"
                                 else [list(x) for x in chip_smoke.spm_vocab(32000)])
        kv = {"general.architecture": "llama", "tokenizer.ggml.model": "llama",
              "tokenizer.ggml.tokens": tokens,
              "tokenizer.ggml.scores": [float(s) for s in scores],
              "tokenizer.ggml.token_type": [int(t) for t in types],
              "tokenizer.ggml.bos_token_id": 1, "tokenizer.ggml.eos_token_id": 2,
              "tokenizer.ggml.unknown_token_id": 0, "tokenizer.ggml.add_bos_token": True}
    else:
        vocab, merges = _bpe_vocab()
        kv = {"tokenizer.ggml.model": "gpt2", "tokenizer.ggml.tokens": vocab}
        if which == "bpe":
            kv["tokenizer.ggml.merges"] = merges
    _write(path, kv)
    t, j = ttok.from_gguf(GGUFReader(path)), jtok.from_gguf(JReader(path))
    assert type(t).__name__ == type(j).__name__
    if which.startswith("spm"):
        assert (t.scores, t.token_types, t.bos_id, t.eos_id, t.unk_id, t.add_bos) \
            == (j.scores, j.token_types, j.bos_id, j.eos_id, j.unk_id, j.add_bos)
        assert t.scores == pytest.approx(scores, rel=1e-6)
    for text in FIXED + _random_strings(50, seed=9):
        assert t.encode(text) == j.encode(text), text
        assert t.decode(t.encode(text)) == j.decode(j.encode(text))


def test_from_gguf_without_tokens_is_none(tmp_path):
    path = tmp_path / "none.gguf"
    _write(path, {"general.architecture": "llama"})
    assert ttok.from_gguf(GGUFReader(path)) is None
