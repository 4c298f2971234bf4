"""Data preparation (ZeroSpeech-2019 subsets, feature extraction, CMVN
normalization) and the training data feed: the ``train.txt`` manifest and
the batches (length-bucketed sampling, hop-aligned crops from the native
loader or the Python collate path, a rank's slice of the global batch, a
prefetch thread that also does the host-to-device copy)."""
