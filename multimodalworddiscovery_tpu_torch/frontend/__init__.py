"""Feature frontends (ported so far: ``speech``, MFCC / log-mel features,
deltas and CMVN, and ``vq``, the k-means frame quantizer)."""
