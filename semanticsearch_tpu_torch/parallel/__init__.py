"""parallel layer of semanticsearch_tpu_torch: the corpus-sharded top-k,
the ring similarity and tensor parallelism over a ``core.mesh.Mesh``."""
