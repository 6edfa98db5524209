"""Decode attention kernels: the Hopper stream-K kernels K1/K2
(:mod:`.lean_decode`, CUDA sources in ``csrc/``), their build
(:mod:`.build`) and the public entry points (:mod:`.ops`)."""
