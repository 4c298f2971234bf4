"""Data preparation (ZeroSpeech-2019 subsets, feature extraction, CMVN
normalization) and the training data feed: the ``train.txt`` manifest and
the Python collate path (length-bucketed sampling, hop-aligned crops, a
prefetch thread that also does the host-to-device copy)."""
