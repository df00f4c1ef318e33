"""Tokenizers loadable from GGUF metadata alone — the port's own copy of
ggml_gfx906_tpu/models/tokenizer.py (plain Python; the port imports nothing
of the JAX package). Encode ids and decoded text equal the reference's.

A byte-level BPE (merges-driven, llama.cpp-compatible GGUF metadata
`tokenizer.ggml.tokens` / `tokenizer.ggml.merges`) with a greedy
longest-match fallback when merges are absent, and a SentencePiece
tokenizer (`tokenizer.ggml.model == "llama"`: score-driven bigram merging,
▁ whitespace convention, <0xXX> byte fallback), so a llama GGUF is served
end to end from the file alone.
"""
from __future__ import annotations

import heapq
import re
from functools import lru_cache


@lru_cache()
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte↔unicode mapping (the standard table)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


_GPT2_SPLIT = re.compile(
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+| ?[^\s\w]+|\s+(?!\S)|\s+""",
    re.UNICODE,
)


class BPETokenizer:
    def __init__(self, tokens: list[str], merges: list[str] | None = None):
        self.tokens = list(tokens)
        self.token_to_id = {t: i for i, t in enumerate(tokens)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.bpe_ranks: dict[tuple[str, str], int] = {}
        if merges:
            for i, m in enumerate(merges):
                a, b = m.split(" ", 1)
                self.bpe_ranks[(a, b)] = i
        self._cache: dict[str, list[str]] = {}

    @property
    def n_vocab(self) -> int:
        return len(self.tokens)

    # -- BPE ---------------------------------------------------------------

    def _bpe(self, token: str) -> list[str]:
        if token in self._cache:
            return self._cache[token]
        word = list(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 30))
            if best not in self.bpe_ranks:
                break
            a, b = best
            out, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = out
        self._cache[token] = word
        return word

    def _greedy(self, token: str) -> list[str]:
        """Longest-match fallback — the reference gpt_tokenize strategy
        (examples/common.cpp): repeatedly take the longest prefix in vocab."""
        out = []
        i = 0
        while i < len(token):
            for j in range(len(token), i, -1):
                cand = token[i:j]
                if cand in self.token_to_id:
                    out.append(cand)
                    i = j
                    break
            else:
                out.append(token[i])  # unknown single char → may drop later
                i += 1
        return out

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for piece in _GPT2_SPLIT.findall(text):
            mapped = "".join(self.byte_encoder[b] for b in piece.encode("utf-8"))
            parts = self._bpe(mapped) if self.bpe_ranks else self._greedy(mapped)
            for p in parts:
                tid = self.token_to_id.get(p)
                if tid is not None:
                    ids.append(tid)
        return ids

    def decode(self, ids: list[int]) -> str:
        text = "".join(self.tokens[i] for i in ids)
        raw = bytearray(self.byte_decoder.get(c, ord(" ")) for c in text)
        return raw.decode("utf-8", errors="replace")


# SentencePiece token types (gguf convention, llama.cpp llama_token_type)
TT_NORMAL, TT_UNKNOWN, TT_CONTROL, TT_USER, TT_UNUSED, TT_BYTE = 1, 2, 3, 4, 5, 6

_SPACE = "▁"  # ▁


class SPMTokenizer:
    """SentencePiece (llama-style) tokenizer from GGUF metadata.

    Greedy score-driven bigram merging over utf-8 characters — the same
    algorithm as llama.cpp's llm_tokenizer_spm: start from single
    characters, repeatedly merge the adjacent pair whose concatenation is
    a vocab piece with the highest score (ties → leftmost), then resolve
    any leftover out-of-vocab symbol through <0xXX> byte-fallback tokens.
    """

    def __init__(self, tokens: list[str], scores: list[float],
                 token_types: list[int] | None = None,
                 bos_id: int = 1, eos_id: int = 2, unk_id: int = 0,
                 add_space_prefix: bool = True, add_bos: bool = True):
        self.tokens = list(tokens)
        self.scores = list(scores)
        self.token_types = (list(token_types) if token_types is not None
                            else [TT_NORMAL] * len(tokens))
        self.token_to_id = {t: i for i, t in enumerate(tokens)}
        self.bos_id, self.eos_id, self.unk_id = bos_id, eos_id, unk_id
        self.add_space_prefix = add_space_prefix
        self.add_bos = add_bos
        self._byte_ids = {}
        for i, (t, tt) in enumerate(zip(self.tokens, self.token_types)):
            if tt == TT_BYTE and len(t) == 6 and t.startswith("<0x"):
                self._byte_ids[int(t[3:5], 16)] = i

    @property
    def n_vocab(self) -> int:
        return len(self.tokens)

    def _piece_score(self, piece: str):
        tid = self.token_to_id.get(piece)
        if tid is None or self.token_types[tid] != TT_NORMAL:
            return None
        return self.scores[tid], tid

    def encode(self, text: str, add_bos: bool | None = None) -> list[int]:
        ids = [self.bos_id] if (self.add_bos if add_bos is None else add_bos) \
            else []
        if not text:
            return ids
        if self.add_space_prefix:
            text = " " + text
        text = text.replace(" ", _SPACE)

        # doubly-linked symbol list over utf-8 characters
        syms = list(text)
        nxt = list(range(1, len(syms) + 1))
        prv = list(range(-1, len(syms) - 1))
        alive = [True] * len(syms)

        heap: list[tuple[float, int, str]] = []

        def push(i):
            j = nxt[i]
            if j >= len(syms):
                return
            sc = self._piece_score(syms[i] + syms[j])
            if sc is not None:
                heapq.heappush(heap, (-sc[0], i, syms[i] + syms[j]))

        for i in range(len(syms) - 1):
            push(i)
        while heap:
            _, i, piece = heapq.heappop(heap)
            j = nxt[i]
            # stale entry: either side merged away since it was pushed
            if not alive[i] or j >= len(syms) or syms[i] + syms[j] != piece:
                continue
            syms[i] = piece
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[j] < len(syms):
                prv[nxt[j]] = i
            if prv[i] >= 0:
                push(prv[i])
            push(i)

        # merged pieces live at their leftmost index, so index order is
        # textual order
        for i in range(len(syms)):
            if alive[i]:
                ids.extend(self._resegment(syms[i]))
        return ids

    def _resegment(self, piece: str) -> list[int]:
        tid = self.token_to_id.get(piece)
        if tid is not None:
            return [tid]
        out = []
        for b in piece.encode("utf-8"):
            bid = self._byte_ids.get(b)
            out.append(bid if bid is not None else self.unk_id)
        return out

    def decode(self, ids: list[int]) -> str:
        buf = bytearray()
        for tid in ids:
            tt = self.token_types[tid]
            if tt in (TT_CONTROL, TT_UNUSED):
                continue
            if tt == TT_BYTE:
                t = self.tokens[tid]
                buf.append(int(t[3:5], 16))
            else:
                buf.extend(self.tokens[tid].encode("utf-8"))
        text = buf.decode("utf-8", errors="replace").replace(_SPACE, " ")
        return text[1:] if self.add_space_prefix and text.startswith(" ") \
            else text


def from_gguf(reader):
    """Tokenizer from GGUF metadata alone (BPE or SentencePiece), or None.

    ref role: examples/common.h:91 gpt_tokenize + vocab-from-model-file."""
    kv = reader.kv
    tokens = kv.get("tokenizer.ggml.tokens")
    if tokens is None:
        return None
    model = kv.get("tokenizer.ggml.model", "gpt2")
    if model == "llama":
        scores = kv.get("tokenizer.ggml.scores") or [0.0] * len(tokens)
        return SPMTokenizer(
            tokens, scores,
            token_types=kv.get("tokenizer.ggml.token_type"),
            bos_id=int(kv.get("tokenizer.ggml.bos_token_id", 1)),
            eos_id=int(kv.get("tokenizer.ggml.eos_token_id", 2)),
            unk_id=int(kv.get("tokenizer.ggml.unknown_token_id", 0)),
            add_space_prefix=bool(kv.get("tokenizer.ggml.add_space_prefix",
                                         True)),
            add_bos=bool(kv.get("tokenizer.ggml.add_bos_token", True)),
        )
    merges = kv.get("tokenizer.ggml.merges")
    return BPETokenizer(tokens, merges)
