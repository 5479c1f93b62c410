"""Feature frontends (ported so far: ``vq``, the k-means frame quantizer)."""
