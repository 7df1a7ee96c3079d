"""cli layer of semanticsearch_tpu_torch."""
