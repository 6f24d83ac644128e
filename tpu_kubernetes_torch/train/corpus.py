"""Tokenizers (port of the tokenizer part of
``tpu_kubernetes/train/corpus.py``).

* **byte** (default): UTF-8 bytes as token ids (vocab 256). No
  dependencies, no downloads, deterministic.
* **hf:<path>**: a Hugging Face tokenizer already present locally;
  ``transformers`` is imported only when one is asked for, and nothing is
  ever downloaded.
"""

from __future__ import annotations

from typing import Callable


def byte_tokenizer() -> tuple[Callable[[str], list[int]], int]:
    """→ (encode, vocab_size): UTF-8 byte-level tokenization."""
    return (lambda text: list(text.encode("utf-8"))), 256


def hf_tokenizer(name_or_path: str) -> tuple[Callable[[str], list[int]], int]:
    """→ (encode, vocab_size) from a LOCALLY available HF tokenizer."""
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(name_or_path, local_files_only=True)
    return (lambda text: tok.encode(text, add_special_tokens=False)), len(tok)


def resolve_tokenizer(spec: str) -> tuple[Callable[[str], list[int]], int]:
    if spec == "byte":
        return byte_tokenizer()
    if spec.startswith("hf:"):
        return hf_tokenizer(spec[3:])
    raise ValueError(f"unknown tokenizer {spec!r} (use 'byte' or 'hf:<path>')")
