"""Feature frontends: ``speech`` (MFCC / log-mel features, deltas and
CMVN), ``vq`` (the k-means frame quantizer), ``image`` (VGG16 concept and
region features), ``detector`` (the learned region-proposal network) and
``pretrained`` (HuBERT / CLIP from local checkpoints)."""
