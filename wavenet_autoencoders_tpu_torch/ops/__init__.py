"""PyTorch NN ops: weight-normed convs, the GLU cell, the conditioning
upsampler and the mixture samplers (channels-last at every function)."""
