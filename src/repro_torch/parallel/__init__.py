"""Tensor and pipeline parallelism: the ring transports, the sharding
rules, the collective policy and the GPipe schedule."""
