"""Document chunking: cleaning, sentence segmentation, the semantic splitter
and grouper, the character baseline and the TSV-to-TSV pipeline."""
