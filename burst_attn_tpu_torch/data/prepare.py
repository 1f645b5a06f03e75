"""Corpus preparation CLI: raw text/binary files -> a BATD token shard (port
of burst_attn_tpu/data/prepare.py).

Byte-level encoding (vocab 256) needs no tokenizer files; --vocab-offset
reserves low ids for special tokens.  For subword vocabularies, tokenize
elsewhere and call data.write_token_file on the id array.

    python -m burst_attn_tpu_torch.data.prepare --out corpus.batd a.txt b.txt
"""

import argparse
from pathlib import Path

import numpy as np

from .loader import write_token_file


def encode_bytes(paths, vocab_offset: int = 0, doc_sep: int = -1):
    """Concatenate files as uint8 streams (+offset), optionally separated
    by a document-separator id.  Returns one int32 token array."""
    parts = []
    for p in paths:
        data = np.frombuffer(Path(p).read_bytes(), np.uint8).astype(np.int32)
        parts.append(data + vocab_offset)
        if doc_sep >= 0:
            parts.append(np.array([doc_sep], np.int32))
    if doc_sep >= 0 and parts:
        parts.pop()  # no trailing separator
    return np.concatenate(parts) if parts else np.zeros((0,), np.int32)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Pack files into a BATD token shard.")
    p.add_argument("inputs", nargs="+", help="text/binary files (as bytes)")
    p.add_argument("--out", required=True)
    p.add_argument("--vocab-offset", type=int, default=0,
                   help="add this to every byte id (reserve special tokens)")
    p.add_argument("--doc-sep", type=int, default=-1,
                   help="token id inserted between files (-1 = none)")
    args = p.parse_args(argv)
    tokens = encode_bytes(args.inputs, args.vocab_offset, args.doc_sep)
    if not len(tokens):
        raise SystemExit("no tokens produced")
    write_token_file(args.out, tokens)
    print(f"{args.out}: {len(tokens)} tokens "
          f"(vocab needs >= {int(tokens.max()) + 1})")


if __name__ == "__main__":
    main()
