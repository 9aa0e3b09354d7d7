"""Distribution layer of the PyTorch port: sharding rules and mesh-level
collectives (the JAX package's ``dist/``).

``sharding`` decides how params/activations/caches map onto the
("data", "model") mesh with divisibility fallbacks, spec for spec as the JAX
package does; ``collectives`` holds the H-tree-shaped mesh collectives (the
paper's spatially-aware communication) on ``torch.distributed``.  The port
runs SPMD: one process a rank, each holding its shard.
"""
