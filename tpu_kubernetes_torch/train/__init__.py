"""Training-side helpers of the port. This slice carries only the
tokenizers (train/corpus.py) that serving needs; the trainer is the next
slice."""
