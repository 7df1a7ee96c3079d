"""training-side modules of semanticsearch_tpu_torch."""
