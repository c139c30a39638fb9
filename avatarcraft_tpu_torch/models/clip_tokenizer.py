"""Pure-Python CLIP BPE tokenizer: the port's own copy of the JAX package's
models/clip_tokenizer.py (reference: models/diffusion.py:56,76-83, the
HuggingFace ``CLIPTokenizer`` called with ``padding='max_length',
max_length=77, truncation=True``).

The JAX package splits words with the ``regex`` package's ``\\p{L}`` and
``\\p{N}`` classes, which the card's machine does not have. This copy uses
the standard library's ``re`` with those classes written out from
``unicodedata`` (every code point whose category starts with L, or with N),
built once at first use:

* letters: the L categories;
* numbers: the N categories (Nd, Nl, No: ``²``, ``½``, ``Ⅻ``);
* whitespace: Unicode's White_Space property, as ``regex``'s ``\\s`` has it
  (the standard library's ``\\s`` also takes U+001C to U+001F);
* U+0345, a combining mark that case-folds to a Greek iota: ``regex``
  under IGNORECASE puts it in neither the letters nor their negation, so
  it ends a word and belongs to none, where ``re`` folds it into the
  letters; ``words`` turns it into a space first.

The split then equals the JAX package's on every code point that this
Python's ``unicodedata`` assigns; code points assigned only by a newer
Unicode version than its tables (``regex`` ships newer ones) are split as
unassigned. Everything else (byte-level BPE with ``</w>``, the specials,
EOS padding and truncation, a vocabulary derived from the merges alone) is
the JAX package's algorithm unchanged.
"""

from __future__ import annotations

import functools
import html
import json
import os
import re
import sys
import unicodedata

BOS_TOKEN = "<|startoftext|>"
EOS_TOKEN = "<|endoftext|>"
# Unicode's White_Space property (regex's \s)
WHITESPACE = "\t-\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029\u202f\u205f\u3000"


@functools.lru_cache()
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2/CLIP reversible byte -> printable unicode char mapping."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _class_body(code_points) -> str:
    """A regular-expression class body of ascending code points, as ranges."""
    ranges: list[list[int]] = []
    for cp in code_points:
        if ranges and ranges[-1][1] == cp - 1:
            ranges[-1][1] = cp
        else:
            ranges.append([cp, cp])
    return "".join(f"\\U{a:08x}" if a == b else f"\\U{a:08x}-\\U{b:08x}" for a, b in ranges)


@functools.lru_cache()
def unicode_classes() -> tuple[str, str]:
    """(letters, numbers): class bodies of \\p{L} and \\p{N} from this
    Python's ``unicodedata``."""
    letters, numbers = [], []
    for cp in range(sys.maxunicode + 1):
        major = unicodedata.category(chr(cp))[0]
        if major == "L":
            letters.append(cp)
        elif major == "N":
            numbers.append(cp)
    return _class_body(letters), _class_body(numbers)


@functools.lru_cache()
def word_pattern() -> re.Pattern:
    """CLIP's word split: the specials, the English contractions, runs of
    letters, single numbers, runs of anything else but whitespace."""
    letters, numbers = unicode_classes()
    return re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        f"|[{letters}]+|[{numbers}]|[^{WHITESPACE}{letters}{numbers}]+",
        re.IGNORECASE,
    )


def get_pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def basic_clean(text: str) -> str:
    try:  # ftfy is optional; identity for well-formed input
        import ftfy

        text = ftfy.fix_text(text)
    except ImportError:
        pass
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text: str) -> str:
    return re.sub(f"[{WHITESPACE}]+", " ", text).strip()


class CLIPTokenizer:
    """Byte-level BPE tokenizer with CLIP semantics.

    ``merges``: ordered list of (a, b) merge pairs. ``vocab``: token -> id;
    derived from the merges when omitted (CLIP's canonical construction:
    256 byte symbols, their ``</w>`` forms, one token per merge, the two
    specials).
    """

    def __init__(self, merges: list[tuple[str, str]], vocab: dict[str, int] | None = None):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.merges = list(merges)
        if vocab is None:
            base = list(bytes_to_unicode().values())
            tokens = base + [v + "</w>" for v in base]
            tokens += ["".join(m) for m in self.merges]
            tokens += [BOS_TOKEN, EOS_TOKEN]
            vocab = {t: i for i, t in enumerate(tokens)}
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(zip(self.merges, range(len(self.merges))))
        self.cache: dict[str, str] = {BOS_TOKEN: BOS_TOKEN, EOS_TOKEN: EOS_TOKEN}
        self.pat = word_pattern()
        self.bos_id = self.encoder[BOS_TOKEN]
        self.eos_id = self.encoder[EOS_TOKEN]
        self.model_max_length = 77

    # ------------------------------------------------------------------
    @classmethod
    def from_pretrained(cls, path: str) -> "CLIPTokenizer":
        """Load from a directory holding ``merges.txt`` (+ optional
        ``vocab.json``), the files HuggingFace tokenizer directories ship."""
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as fp:
            lines = fp.read().split("\n")
        merges = [tuple(l.split()) for l in lines if l and not l.startswith("#")]
        merges = [m for m in merges if len(m) == 2]
        vocab = None
        vpath = os.path.join(path, "vocab.json")
        if os.path.exists(vpath):
            with open(vpath, encoding="utf-8") as fp:
                vocab = json.load(fp)
        return cls(merges, vocab)

    def save_assets(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as fp:
            fp.write("#version: 0.2\n")
            fp.write("\n".join(" ".join(m) for m in self.merges))
            fp.write("\n")
        with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as fp:
            json.dump(self.encoder, fp, ensure_ascii=False)

    # ------------------------------------------------------------------
    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"

        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def words(self, text: str) -> list[str]:
        """The cleaned, lowercased text split into CLIP's words."""
        return self.pat.findall(whitespace_clean(basic_clean(text)).lower().replace("\u0345", " "))

    def encode(self, text: str) -> list[int]:
        """Text -> BPE ids (no specials)."""
        ids: list[int] = []
        for token in self.words(text):
            mapped = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(mapped).split(" "))
        return ids

    def decode(self, ids: list[int]) -> str:
        text = "".join(self.decoder[i] for i in ids if i not in (self.bos_id, self.eos_id))
        data = bytearray(self.byte_decoder[c] for c in text)
        return data.decode("utf-8", errors="replace").replace("</w>", " ").strip()

    def __call__(self, texts: list[str] | str, max_length: int | None = None) -> list[list[int]]:
        """BOS + tokens + EOS, truncated to max_length keeping a final EOS,
        padded with EOS to max_length: [B][L] ints."""
        if isinstance(texts, str):
            texts = [texts]
        L = max_length or self.model_max_length
        batch = []
        for t in texts:
            ids = [self.bos_id] + self.encode(t) + [self.eos_id]
            if len(ids) > L:
                ids = ids[: L - 1] + [self.eos_id]
            ids = ids + [self.eos_id] * (L - len(ids))
            batch.append(ids)
        return batch


def make_toy_tokenizer() -> CLIPTokenizer:
    """Small but real tokenizer for tests and random-weight runs: the byte
    alphabet and a handful of merges, the full asset's construction path.
    Its ids (below 530) index any CLIP token table."""
    merges = [
        ("t", "h"),
        ("th", "e</w>"),
        ("a", "n"),
        ("an", "d</w>"),
        ("i", "n"),
        ("o", "f</w>"),
        ("r", "e"),
        ("e", "r"),
        ("in", "g</w>"),
        ("h", "u"),
        ("hu", "l"),
        ("hul", "k</w>"),
        ("s", "t"),
        ("st", "y"),
        ("l", "e</w>"),
        ("sty", "le</w>"),
    ]
    return CLIPTokenizer(merges)
