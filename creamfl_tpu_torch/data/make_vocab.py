"""Vocabulary builder CLI (reference `src/datasets/vocabs/make_vocab.py`).

Port of the JAX package's ``data/make_vocab.py``: builds a
frequency-thresholded ``Vocabulary`` from COCO-style caption JSONs with the
port's ``treebank_tokenize`` and saves it in the reference's pickle
format:

  python -m creamfl_tpu_torch.data.make_vocab \\
      --ann captions_train2014.json [--ann captions_val2014.json] \\
      --threshold 4 --out coco_vocab.pkl
"""

from __future__ import annotations

import argparse
import json

from creamfl_tpu_torch.data.tokenize import treebank_tokenize
from creamfl_tpu_torch.data.vocab import Vocabulary


def captions_from_json(path: str):
    with open(path) as f:
        data = json.load(f)
    for ann in data["annotations"]:
        yield ann["caption"]


def main(argv=None):
    parser = argparse.ArgumentParser(description="Build caption vocab")
    parser.add_argument("--ann", action="append", required=True,
                        help="caption annotation json (repeatable)")
    parser.add_argument("--threshold", type=int, default=4)
    parser.add_argument("--out", type=str, required=True)
    args = parser.parse_args(argv)

    def token_lists():
        for ann in args.ann:
            for caption in captions_from_json(ann):
                yield treebank_tokenize(caption)

    vocab = Vocabulary.build(token_lists(), threshold=args.threshold)
    vocab.save_to_pickle(args.out)
    print(f"vocab: {len(vocab)} words -> {args.out}")


if __name__ == "__main__":
    main()
